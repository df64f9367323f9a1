"""FineTunePublisher of the port (mirrors
``mxnet_tpu/serving/fleet/trainloop.py``): continuous fine-tune ->
checkpoint -> publish.

Closes the loop the fleet exists for: a training job — typically a
gluon ``Trainer`` stepping a block — runs N steps, commits a
sharded-manifest checkpoint (``resilience.CheckpointManager``: atomic
commit, CRC'd shards, torn writes invisible), and hot-swaps the result
into a live :class:`~.router.FleetRouter` entry. Training and serving
share ONE metrics registry, so a single scrape shows the step that
produced the weights next to the swap that started serving them.

The publisher owns no training semantics: ``train_step()`` is any
callable advancing the job, ``get_arrays()`` returns the checkpoint
array dict (e.g. ``{name: param.data() for ...}``). Versions count up
from ``version_start`` so the ``mxtpu_fleet_active_version`` gauge is
monotone per model.
"""
from __future__ import annotations

__all__ = ["FineTunePublisher"]


class FineTunePublisher:
    """Drive ``rounds`` of (train ``steps_per_publish`` steps ->
    checkpoint -> ``router.publish``) against one fleet entry."""

    def __init__(self, router, model, train_step, get_arrays, run_dir,
                 steps_per_publish=1, keep=3, num_shards=None,
                 version_start=1, drain_timeout=None):
        from ...resilience.checkpoint import CheckpointManager
        self.router = router
        self.model = model
        self.train_step = train_step
        self.get_arrays = get_arrays
        # sync saves: publish() reads the checkpoint back immediately,
        # so the commit must be on disk when save() returns
        self.manager = CheckpointManager(run_dir, keep=keep,
                                         async_=False,
                                         num_shards=num_shards)
        self.steps_per_publish = int(steps_per_publish)
        self.drain_timeout = drain_timeout
        self.step = 0
        self.version = int(version_start) - 1

    def run_once(self):
        """One round: train, checkpoint (sharded manifest, atomic
        commit), publish into the live router. Returns the published
        version. A crash anywhere leaves the previous version serving:
        before the checkpoint commit the torn write is invisible to
        ``latest_checkpoint``; during publish the router's rollback
        applies."""
        for _ in range(self.steps_per_publish):
            self.train_step()
            self.step += 1
        arrays = self.get_arrays()
        ckpt_dir = self.manager.save(arrays, step=self.step)
        self.version += 1
        return self.router.publish(self.model, self.version,
                                   ckpt_dir=ckpt_dir,
                                   drain_timeout=self.drain_timeout)

    def run(self, rounds):
        """``rounds`` back-to-back fine-tune->publish cycles; returns
        the last published version."""
        version = None
        for _ in range(int(rounds)):
            version = self.run_once()
        return version
