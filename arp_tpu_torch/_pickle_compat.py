"""The reference's pickles without flax, optax, jax or cloudpickle: a reader and a writer.

The JAX package writes its reference-format checkpoints with cloudpickle:
``{"step", "epoch", "variant", "state"}``, ``state`` a flax ``TrainState``
whose params are jax arrays and whose optimizer chain and state are optax's
objects, its closures pickled by value.  :func:`load` reads such a stream with
a stdlib unpickler whose ``find_class`` gives numpy's own globals and a
stand-in class for every other one, so nothing of those packages is imported.
Once loaded, the stand-ins become plain data:

  * a flax ``TrainState`` becomes a :class:`ReferenceTrainState` (``.step``,
    ``.params``, ``.apply_fn``, ``.tx``, ``.opt_state``);
  * a flax ``FrozenDict`` becomes a dict;
  * a jax array becomes the numpy array it carries;
  * anything else (a function, an optax transform or state, a module) becomes
    an :class:`OpaqueReference`, which raises when called.

:func:`dump` writes a stream in which a :class:`ReferenceTrainState` is named
``flax.training.train_state.TrainState``, so the JAX package (and the
reference's own tools) unpickle it as a real flax TrainState.  The C pickler
refuses a global it cannot import, so the writer is pickle's pure-Python one
with its ``save_global`` taught that one name.
"""

from __future__ import annotations

import dataclasses
import importlib
import pickle
from typing import Any

FLAX_TRAIN_STATE = ("flax.training.train_state", "TrainState")
FLAX_FROZEN_DICT = ("flax.core.frozen_dict", "FrozenDict")
JAX_RECONSTRUCT_ARRAY = ("jax._src.array", "_reconstruct_array")

# the numpy modules a pickled array or dtype names (numpy 2 spells numpy.core as numpy._core)
_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray", "numpy.core.numeric",
                  "numpy._core.numeric", "numpy.dtypes")
_BUILTINS = {"set": set, "frozenset": frozenset, "slice": slice, "complex": complex, "bytearray": bytearray,
             "range": range, "list": list, "dict": dict, "tuple": tuple, "object": object}


@dataclasses.dataclass
class ReferenceTrainState:
    """A flax ``TrainState``'s fields, as read from or written to a reference pickle."""

    step: Any = 0
    apply_fn: Any = None
    params: Any = None
    tx: Any = None
    opt_state: Any = None

    def replace(self, **changes) -> "ReferenceTrainState":
        return dataclasses.replace(self, **changes)


class OpaqueReference:
    """A global of the pickle that the port does not rebuild (an optax transform or state, a
    function pickled by value, a module), by name."""

    def __init__(self, name: str):
        self.name = name

    def __call__(self, *args, **kwargs):
        raise TypeError(f"{self.name} was read from a reference pickle as a placeholder: it cannot be called")

    def __repr__(self):
        return f"OpaqueReference({self.name})"


class _StandIn:
    """A value the stream builds from a global outside numpy: calling, constructing and ``BUILD``
    only note their arguments.  Subclassed once per global (``NEWOBJ`` needs a class)."""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj._ref_args, obj._ref_kwargs, obj._ref_state, obj._ref_callee = args, kwargs, None, None
        return obj

    def __setstate__(self, state):
        self._ref_state = state

    def __call__(self, *args, **kwargs):
        out = type(self)(*args, **kwargs)
        out._ref_callee = self
        return out


_STAND_INS: dict = {}


def _stand_in(module: str, name: str) -> type:
    key = (module, name)
    if key not in _STAND_INS:
        _STAND_INS[key] = type(name, (_StandIn,), {"_ref_name": f"{module}.{name}", "_ref_key": key})
    return _STAND_INS[key]


def _reconstruct_array(fun, args, arr_state, aval_state):
    """jax's ``_reconstruct_array`` without jax: the numpy array the pickle carries."""
    del aval_state
    value = fun(*args)
    value.__setstate__(arr_state)
    return value


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _NUMPY_MODULES:
            try:
                mod = importlib.import_module(module)
            except ImportError:  # the other numpy's spelling of its core module
                mod = importlib.import_module(module.replace("numpy._core", "numpy.core") if "_core" in module
                                              else module.replace("numpy.core", "numpy._core"))
            return getattr(mod, name)
        if module == "builtins" and name in _BUILTINS:
            return _BUILTINS[name]
        if (module, name) == JAX_RECONSTRUCT_ARRAY:
            return _reconstruct_array
        return _stand_in(module, name)


def _plain(obj, memo: dict):
    """The loaded tree with its stand-ins turned into plain data (see the module docstring)."""
    key = id(obj)
    if key in memo:
        return memo[key]
    if isinstance(obj, dict):
        out = memo[key] = {}
        out.update((k, _plain(v, memo)) for k, v in obj.items())
        return out
    if isinstance(obj, list):
        out = memo[key] = []
        out.extend(_plain(v, memo) for v in obj)
        return out
    if type(obj) is tuple:
        out = memo[key] = tuple(_plain(v, memo) for v in obj)
        return out
    if not isinstance(obj, _StandIn):
        return obj
    ref = getattr(type(obj), "_ref_key", None)
    if ref == FLAX_TRAIN_STATE and obj._ref_callee is None:
        fields = dict(obj._ref_kwargs)
        if isinstance(obj._ref_state, dict):
            fields.update(obj._ref_state)
        out = memo[key] = ReferenceTrainState()
        for name, value in fields.items():
            setattr(out, name, _plain(value, memo))
        return out
    if ref == FLAX_FROZEN_DICT and obj._ref_callee is None:
        source = obj._ref_args[0] if obj._ref_args else obj._ref_state
        out = memo[key] = {}
        out.update((k, _plain(v, memo)) for k, v in dict(source or {}).items())
        return out
    out = memo[key] = OpaqueReference(obj._ref_name if obj._ref_callee is None else f"{obj._ref_callee._ref_name}(...)")
    return out


def load(f) -> Any:
    """Unpickle a reference-format stream from the binary file ``f`` (see the module docstring)."""
    return _plain(_Unpickler(f).load(), {})


class _Pickler(pickle._Pickler):
    """pickle's pure-Python pickler, writing :class:`ReferenceTrainState` under flax's name."""

    def save_global(self, obj, name=None):
        if obj is not ReferenceTrainState:
            return super().save_global(obj, name)
        for part in FLAX_TRAIN_STATE:
            self.save(part)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def dump(obj: Any, f) -> None:
    """Pickle ``obj`` to the binary file ``f`` (protocol 4; see the module docstring)."""
    _Pickler(f, protocol=4).dump(obj)
