"""Pretrained weights for the vision zoo, from a local file only."""


def load_pretrained(net, pretrained, params_file, ctx=None):
    """``net`` with the parameters of ``params_file`` (a file of
    ``save_parameters``, either package's) when ``pretrained``; nothing
    is downloaded, so ``pretrained`` without a file raises."""
    if not pretrained:
        return net
    if not params_file:
        raise RuntimeError(
            "pretrained weights require a local params_file= path "
            "(nothing is downloaded)")
    net.load_parameters(params_file, ctx=ctx)
    return net
