"""Run a JAX-side test module's cases against the port.

``port_module(path)`` loads a test file of the JAX package (under a
private module name, so pytest does not collect it twice) and returns
a namespace in which every function of that file runs against
``routest_tpu_torch`` instead of ``routest_tpu``: module-level imports
of the JAX package are replaced by the port's objects of the same
name, and imports made inside a function body resolve to the port too
(through the namespace's own ``__import__``). The case bodies, and so
their pinned expectations, stay the JAX file's bytes.
"""

import builtins
import importlib
import importlib.util
import os
import types

_JAX, _PORT = "routest_tpu", "routest_tpu_torch"


def port_name(name: str) -> str:
    """``routest_tpu.x.y`` → ``routest_tpu_torch.x.y`` (others as-is)."""
    if name == _JAX or name.startswith(_JAX + "."):
        return _PORT + name[len(_JAX):]
    return name


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    return builtins.__import__(port_name(name) if level == 0 else name,
                               globals, locals, fromlist, level)


def _port_value(key, value):
    """The port's counterpart of a module-level binding of the JAX
    package, else the value itself."""
    if isinstance(value, types.ModuleType):
        if port_name(value.__name__) != value.__name__:
            return importlib.import_module(port_name(value.__name__))
        return value
    owner = getattr(value, "__module__", None)
    if not isinstance(owner, str) or port_name(owner) == owner:
        owner = type(value).__module__
        if port_name(owner) == owner:
            return value
        # an instance (``UNDEFINED``): the port's binding of that name
        return getattr(importlib.import_module(port_name(owner)), key)
    target = importlib.import_module(port_name(owner))
    for part in getattr(value, "__qualname__", key).split("."):
        target = getattr(target, part)
    return target


def load_jax_cases(path: str) -> types.ModuleType:
    """Import a test file by path under a private name."""
    name = "_jaxcases_" + os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def port_namespace(module: types.ModuleType, **overrides) -> dict:
    """``module``'s globals with the JAX package swapped for the port's
    and every function of the module rebound to them. ``overrides``
    replace further names (paths, fixtures' stand-ins)."""
    return _namespace(module, True, overrides)


def rebound_namespace(module: types.ModuleType, **overrides) -> dict:
    """``module``'s globals with only ``overrides`` replaced (the JAX
    side of a comparison that swaps a class for a recording one)."""
    return _namespace(module, False, overrides)


def _namespace(module, translate, overrides) -> dict:
    g = {}
    for key, value in module.__dict__.items():
        g[key] = value if key.startswith("__") or not translate \
            else _port_value(key, value)
    if translate:
        port_builtins = dict(vars(builtins))
        port_builtins["__import__"] = _port_import
        g["__builtins__"] = port_builtins
    g.update(overrides)
    for key, value in list(g.items()):
        if (isinstance(value, types.FunctionType)
                and value.__module__ == module.__name__
                and key not in overrides):
            fn = types.FunctionType(value.__code__, g, value.__name__,
                                    value.__defaults__, value.__closure__)
            fn.__kwdefaults__ = value.__kwdefaults__
            g[key] = fn
    return g


def case_names(module: types.ModuleType):
    """The module's test functions, in file order."""
    return [k for k, v in module.__dict__.items()
            if k.startswith("test_") and isinstance(v, types.FunctionType)]
