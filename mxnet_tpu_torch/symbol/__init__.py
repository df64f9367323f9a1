"""Symbol: the lazy graph construction API of the port (mirrors
``mxnet_tpu/symbol``; reference: python/mxnet/symbol/)."""
from .symbol import (Symbol, var, Variable, Group, load, load_json,
                     zeros, ones, arange)  # noqa: F401
from .register import _init_symbol_module

# inject the generated op namespace into the PACKAGE namespace only —
# never into symbol.py itself (generated names like `sum` would shadow
# builtins used by Symbol methods)
_init_symbol_module(globals())
