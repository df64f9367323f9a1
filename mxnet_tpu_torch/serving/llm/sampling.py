"""Sampling for the LLM decode engine (the port of
``mxnet_tpu/serving/llm/sampling.py``), as tensor functions on the
batch's device.

- :class:`SamplingParams` — per-sequence knobs: ``temperature`` (0 =
  greedy), ``top_k`` (0 = off), ``top_p`` (1 = off), ``seed``;
- :func:`row_keys` — per-row keys ``(seed, counter, tag)`` where
  ``counter`` is the ABSOLUTE index of the token being sampled, and
  :func:`philox4x32` — the counter-based Philox4x32-10 generator the
  noise is drawn from. Noise is a pure function of (seed, position,
  tag) on every device, so preempt/restart resumes a sampled stream
  bit-identically (the JAX package's threefry bits differ; streams are
  held to the JAX ones by distribution, not by bits);
- :func:`adjusted_log_probs` — temperature + top-k + top-p masking,
  renormalized (the shared distribution transform);
- :func:`sample_tokens` / :func:`sample_and_probs` — Gumbel-max draws,
  with ``temperature <= 0`` rows returning the bit-exact raw argmax;
- :func:`spec_accept` / :func:`spec_accept_greedy` — the speculative
  accept rule over ``K + 1`` scored positions (with ``K = 0``, as in
  this port's engine, one sampled or argmax token per row).
"""
from __future__ import annotations

import torch

__all__ = ["SamplingParams", "GREEDY", "row_keys", "philox4x32",
           "adjusted_log_probs", "sample_tokens", "sample_and_probs",
           "spec_accept", "spec_accept_greedy",
           "TAG_SAMPLE", "TAG_ACCEPT", "TAG_DRAFT"]

# noise sub-streams: the accept uniforms, the target's sampling gumbels
# and a draft's proposal gumbels never alias at one position
TAG_SAMPLE = 0
TAG_ACCEPT = 1
TAG_DRAFT = 2

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


class SamplingParams:
    """Per-sequence sampling knobs. ``temperature <= 0`` means greedy
    (bit-exact argmax); ``top_k == 0`` and ``top_p == 1.0`` disable
    those masks. ``seed`` roots the per-sequence noise — two submissions
    with the same seed, prompt and params produce the same tokens."""

    __slots__ = ("temperature", "top_k", "top_p", "seed")

    def __init__(self, temperature=0.0, top_k=0, top_p=1.0, seed=0):
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), "
                             f"got {top_k}")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")

    @property
    def greedy(self):
        return self.temperature <= 0.0

    def __repr__(self):
        return (f"SamplingParams(temperature={self.temperature}, "
                f"top_k={self.top_k}, top_p={self.top_p}, "
                f"seed={self.seed})")


GREEDY = SamplingParams()


def row_keys(seeds, counters, tag):
    """Per-row keys: int64 ``[..., 3]`` = (seed, counter, tag), each a
    32-bit word. seeds/counters: integer tensors of one shape."""
    seeds = seeds.long() & _M32
    counters = counters.long() & _M32
    return torch.stack([seeds, counters,
                        torch.full_like(seeds, int(tag))], dim=-1)


def _mulhilo(a, b):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a``
    and the 32-bit words in int64 tensor ``b``, without int64
    overflow."""
    p_lo = a * (b & 0xFFFF)                  # < 2**48
    p_hi = a * (b >> 16)                     # < 2**48
    t = (p_lo >> 16) + p_hi                  # < 2**49
    return t >> 16, ((t & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32(c0, c1, c2, c3, k0, k1, rounds=10):
    """Philox4x32-10 on int64 tensors holding 32-bit words (broadcast
    together). Returns the four output words."""
    for _ in range(rounds):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _M32
        k1 = (k1 + _PHILOX_W[1]) & _M32
    return c0, c1, c2, c3


def _uniform_bits(keys, n):
    """``n`` uniforms in (0, 1) per key ``[..., 3]`` → ``[..., n]``:
    Philox key (seed, tag), counter (block, position, 0, 0)."""
    lead = keys.shape[:-1]
    nblk = -(-n // 4)
    blk = torch.arange(nblk, dtype=torch.int64, device=keys.device)
    seed = keys[..., 0:1]
    ctr = keys[..., 1:2]
    tag = keys[..., 2:3]
    zero = torch.zeros_like(blk)
    words = philox4x32(blk, ctr + zero, zero, zero, seed + zero,
                       tag + zero)
    bits = torch.stack(words, dim=-1).reshape(*lead, nblk * 4)[..., :n]
    # 24 high bits, centred in their cell: never exactly 0 or 1
    return ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def _gumbel(keys, n):
    """Gumbel(0, 1) noise ``[..., n]`` from keys ``[..., 3]``."""
    return -torch.log(-torch.log(_uniform_bits(keys, n)))


def _uniform(keys):
    """One U(0, 1) draw per key ``[..., 3]`` → ``[...]``."""
    return _uniform_bits(keys, 1)[..., 0]


def adjusted_log_probs(logits, temperature, top_k, top_p):
    """Temperature + top-k + top-p transform, renormalized.

    logits: f32 [..., V]; temperature/top_k/top_p broadcast over the
    leading dims. Returns log-probs [..., V] with masked entries at
    -inf. Rows with ``temperature <= 0`` get the transform at a tiny
    positive temperature — callers route greedy rows through the raw
    argmax instead (:func:`sample_tokens` does)."""
    V = logits.shape[-1]
    t = torch.clamp(temperature, min=1e-6)[..., None]
    scaled = logits.float() / t
    # top-k: keep scores >= the k-th largest (0 = keep all)
    k_eff = torch.where(top_k <= 0, V, torch.clamp(top_k, 1, V)).long()
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, -1, (k_eff - 1)[..., None])
    neg = float("-inf")
    masked = torch.where(scaled >= kth, scaled, neg)
    # top-p over the top-k-masked distribution: keep the smallest prefix
    # of descending probabilities whose mass reaches top_p (the crossing
    # token included; probability ties keep together)
    probs = torch.softmax(masked, dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sp, dim=-1)
    keep_sorted = (csum - sp) < top_p[..., None]
    nkeep = keep_sorted.sum(dim=-1, keepdim=True)
    thresh = torch.gather(sp, -1, nkeep - 1)
    masked = torch.where(probs >= thresh, masked, neg)
    return torch.log_softmax(masked, dim=-1)


def sample_tokens(logits, temperature, top_k, top_p, keys):
    """One sampled token per row via the Gumbel-max trick. keys:
    ``[..., 3]`` from :func:`row_keys`. Rows with ``temperature <= 0``
    return the BIT-EXACT ``argmax(logits)``."""
    lp = adjusted_log_probs(logits, temperature, top_k, top_p)
    sampled = torch.argmax(lp + _gumbel(keys, lp.shape[-1]), dim=-1)
    return torch.where(temperature <= 0, torch.argmax(logits, dim=-1),
                       sampled).to(torch.int32)


def sample_and_probs(logits, temperature, top_k, top_p, keys):
    """One sampled token per row PLUS the full adjusted probability
    vector. Returns (tokens [...] int32, probs [..., V] f32)."""
    lp = adjusted_log_probs(logits, temperature, top_k, top_p)
    sampled = torch.argmax(lp + _gumbel(keys, lp.shape[-1]), dim=-1)
    toks = torch.where(temperature <= 0, torch.argmax(logits, dim=-1),
                       sampled).to(torch.int32)
    return toks, torch.exp(lp)


def _commit_layout(accepted_drafts, prefix, n_acc, final):
    """Accepted drafts, then the final token at index ``n_acc``."""
    S = accepted_drafts.shape[0]
    out = torch.where(prefix.bool(), accepted_drafts, 0)
    out = torch.cat([out, torch.zeros((S, 1), dtype=out.dtype,
                                      device=out.device)], dim=1)
    rows = torch.arange(S, device=out.device)
    out[rows, n_acc] = final.to(out.dtype)
    return out.to(torch.int32), n_acc.to(torch.int32)


def spec_accept_greedy(target_logits, draft_tokens, n_draft):
    """Greedy accept rule: accept draft j iff it equals the raw-logits
    argmax at its position; the replacement/bonus token IS the argmax
    at the first open position. Returns (tokens [S, K+1], n_accepted
    [S])."""
    K = target_logits.shape[1] - 1
    raw_arg = torch.argmax(target_logits, dim=-1)            # [S, K+1]
    jpos = torch.arange(K, device=raw_arg.device)[None, :]
    live = jpos < n_draft[:, None]
    accept = (draft_tokens.long() == raw_arg[:, :K]) & live
    prefix = torch.cumprod(accept.long(), dim=1)
    n_acc = prefix.sum(dim=1)
    final = torch.gather(raw_arg, 1, n_acc[:, None])[:, 0]
    return _commit_layout(draft_tokens.long(), prefix, n_acc, final)


def spec_accept(target_logits, draft_tokens, draft_probs, n_draft,
                temperature, top_k, top_p, accept_keys, sample_keys):
    """The speculative-sampling accept rule over one verify dispatch.

    target_logits: [S, K+1, V]; draft_tokens: [S, K]; draft_probs:
    [S, K, V] (the draft's adjusted probabilities); n_draft: [S] live
    proposals per row (0 plain-samples position 0);
    temperature/top_k/top_p: [S]; accept_keys: [S, K, 3];
    sample_keys: [S, K+1, 3]. Accept draft j with probability
    ``min(1, p_j(d_j) / q_j(d_j))``; at the first rejection sample the
    residual ``max(p - q, 0)``; if all survive, sample the bonus token.
    Greedy rows accept iff the draft equals the raw argmax. Returns
    (tokens [S, K+1] int32, n_accepted [S] int32)."""
    S, K1, V = target_logits.shape
    K = K1 - 1
    greedy = (temperature <= 0)[:, None]
    lp = adjusted_log_probs(target_logits, temperature[:, None],
                            top_k[:, None], top_p[:, None])
    p = torch.exp(lp)
    raw_arg = torch.argmax(target_logits, dim=-1)            # [S, K+1]
    d = draft_tokens.long()
    jpos = torch.arange(K, device=d.device)[None, :]
    live = jpos < n_draft[:, None]
    p_chosen = torch.gather(p[:, :K], -1, d[..., None])[..., 0]
    q_chosen = torch.gather(draft_probs, -1, d[..., None])[..., 0]
    u = _uniform(accept_keys)                                # [S, K]
    stochastic = u * torch.clamp(q_chosen, min=1e-30) <= p_chosen
    greedy_ok = d == raw_arg[:, :K]
    accept = torch.where(greedy, greedy_ok, stochastic) & live
    prefix = torch.cumprod(accept.long(), dim=1)
    n_acc = prefix.sum(dim=1)                                # [S]
    # the position emitting the replacement (first reject) or bonus
    pos = n_acc[:, None, None].expand(S, 1, V)
    p_pos = torch.gather(p, 1, pos)[:, 0]                    # [S, V]
    q_pad = torch.cat([draft_probs, torch.zeros(
        (S, 1, V), dtype=draft_probs.dtype, device=draft_probs.device)],
        dim=1)
    rejected_draft = (n_acc < n_draft)[:, None]
    q_pos = torch.where(rejected_draft, torch.gather(q_pad, 1, pos)[:, 0],
                        0.0)
    resid = torch.clamp(p_pos - q_pos, min=0.0)
    rsum = resid.sum(dim=-1, keepdim=True)
    # numerically empty residual (p <= q everywhere) => p == q
    resid = torch.where(rsum > 0, resid, p_pos)
    rsum = resid.sum(dim=-1, keepdim=True)
    rlog = torch.log(torch.clamp(resid / rsum, min=1e-38))
    g_pos = _gumbel(torch.gather(
        sample_keys, 1, n_acc[:, None, None].expand(S, 1, 3))[:, 0], V)
    sampled = torch.argmax(rlog + g_pos, dim=-1)
    arg_pos = torch.gather(raw_arg, 1, n_acc[:, None])[:, 0]
    final = torch.where(greedy[:, 0], arg_pos, sampled)
    return _commit_layout(d, prefix, n_acc, final)
