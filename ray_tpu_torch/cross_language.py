"""Cross-language boundary — msgpack-typed task calls.

Reference: `python/ray/cross_language.py` + the msgpack serialization
boundary the reference uses between language workers (`java_function`,
`cpp_function`: tasks named by symbol, arguments restricted to
msgpack-representable types).  Here the non-Python frontend is the C++
client (`cpp/`), which drives the cluster through the thin-client server
(`client/server.py`) over the same socket RPC the Python client uses —
frames msgpack instead of pickle, sniffed per-frame in `_private/rpc.py`.

Functions callable from other languages are named either by an explicit
`register("name", fn)` or by import path `"pkg.module:attr"`.  Values
cross the boundary as msgpack types; numpy arrays ride as a tagged map
{"__nd__": 1, dtype, shape, data} for zero-copy-ish dense transfer.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

import numpy as np

_REGISTRY: Dict[str, Callable] = {}


def register(name: str, fn: Callable) -> None:
    """Expose `fn` to cross-language callers under `name`."""
    _REGISTRY[name] = fn


def resolve(func: str) -> Callable:
    """Registered name first, then `"pkg.module:attr"` import path."""
    fn = _REGISTRY.get(func)
    if fn is not None:
        return fn
    if ":" not in func:
        raise KeyError(
            f"cross-language function '{func}' is not registered and is "
            f"not a 'module:attr' import path")
    mod_name, attr = func.split(":", 1)
    mod = importlib.import_module(mod_name)
    fn = mod
    for part in attr.split("."):
        fn = getattr(fn, part)
    if not callable(fn):
        raise TypeError(f"'{func}' resolved to non-callable {fn!r}")
    return fn


# ---------------------------------------------------------- C++ task libs
class _CppFunction:
    """A remote-able callable that executes a C++ task-library function
    (reference: `cross_language.cpp_function`; architecture note in
    `cpp/include/ray_tpu/task_lib.hpp` — the library is dlopen'd inside
    the Python worker and called over a msgpack C ABI)."""

    def __init__(self, lib_path: str, func_name: str):
        self._lib_path = lib_path
        self._func = func_name
        self.__name__ = f"cpp:{func_name}"
        self.__qualname__ = self.__name__

    def __call__(self, *args, **kwargs):
        import ctypes
        import os

        import msgpack

        if kwargs:
            raise TypeError(
                f"C++ task '{self._func}' is positional-only (msgpack "
                f"C ABI); got keyword args {sorted(kwargs)}")

        # Resolve relative paths in the *worker's* cwd: with runtime_env
        # working_dir the .so lands in the unpacked working dir, which is
        # the worker's cwd — an absolute driver-side path would not exist
        # on remote nodes.
        path = self._lib_path
        if not os.path.isabs(path):
            path = os.path.join(os.getcwd(), path)
        lib = _load_task_lib(path)
        packed = msgpack.packb([encode(a) for a in args],
                               use_bin_type=True)
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        rc = lib.ray_tpu_call(
            self._func.encode(), packed, len(packed),
            ctypes.byref(out), ctypes.byref(out_len))
        result = msgpack.unpackb(_read_and_free(lib, out, out_len),
                                 raw=False)
        if rc != 0:
            names = _list_task_lib(lib)
            raise RuntimeError(
                f"C++ task '{self._func}' failed: {result} "
                f"(library exports: {names})")
        return decode(result)


_TASK_LIBS: Dict[str, Any] = {}


def _read_and_free(lib, out, out_len) -> bytes:
    import ctypes

    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.ray_tpu_free(out)


def _load_task_lib(path: str):
    lib = _TASK_LIBS.get(path)
    if lib is None:
        import ctypes

        lib = ctypes.CDLL(path)
        lib.ray_tpu_call.restype = ctypes.c_int
        lib.ray_tpu_call.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t)]
        lib.ray_tpu_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.ray_tpu_list_tasks.restype = ctypes.c_int
        lib.ray_tpu_list_tasks.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_size_t)]
        try:  # actor ABI is optional (task-only libraries lack it)
            lib.ray_tpu_actor_new.restype = ctypes.c_int
            lib.ray_tpu_actor_new.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_size_t)]
            lib.ray_tpu_actor_call.restype = ctypes.c_int
            lib.ray_tpu_actor_call.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_size_t)]
            lib.ray_tpu_actor_free.argtypes = [ctypes.c_void_p]
        except AttributeError:
            pass
        _TASK_LIBS[path] = lib
    return lib


def _list_task_lib(lib) -> list:
    import ctypes

    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    lib.ray_tpu_list_tasks(ctypes.byref(out), ctypes.byref(out_len))
    raw = _read_and_free(lib, out, out_len)
    return [n.decode() for n in raw.split(b"\0") if n]


class _CppActorBase:
    """Instance side of a C++ actor class: the constructor runs INSIDE
    the actor worker process, dlopens the task library, and instantiates
    the registered C++ actor; method calls dispatch by name over the
    msgpack C ABI (reference: the cpp worker's RAY_REMOTE actor classes;
    architecture note in `cpp/include/ray_tpu/task_lib.hpp`)."""

    _LIB: str = ""
    _CLS: str = ""

    def __init__(self, *args):
        import ctypes
        import os

        import msgpack

        path = self._LIB
        if not os.path.isabs(path):
            path = os.path.join(os.getcwd(), path)
        lib = _load_task_lib(path)
        packed = msgpack.packb([encode(a) for a in args],
                               use_bin_type=True)
        handle = ctypes.c_void_p()
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        rc = lib.ray_tpu_actor_new(
            self._CLS.encode(), packed, len(packed),
            ctypes.byref(handle), ctypes.byref(out), ctypes.byref(out_len))
        err = msgpack.unpackb(_read_and_free(lib, out, out_len), raw=False)
        if rc != 0:
            raise RuntimeError(
                f"C++ actor '{self._CLS}' construction failed: {err}")
        self._lib = lib
        self._handle = handle

    def __getattr__(self, method):
        # Worker-side dispatch: the runtime getattrs the instance by
        # method name, so C++ methods need no Python declarations.
        if method.startswith("_"):
            raise AttributeError(method)

        def _call(*args):
            import ctypes

            import msgpack

            packed = msgpack.packb([encode(a) for a in args],
                                   use_bin_type=True)
            out = ctypes.POINTER(ctypes.c_uint8)()
            out_len = ctypes.c_size_t()
            rc = self._lib.ray_tpu_actor_call(
                self._handle, method.encode(), packed, len(packed),
                ctypes.byref(out), ctypes.byref(out_len))
            result = msgpack.unpackb(
                _read_and_free(self._lib, out, out_len), raw=False)
            if rc != 0:
                raise RuntimeError(
                    f"C++ actor method '{self._CLS}.{method}' failed: "
                    f"{result}")
            return decode(result)

        return _call

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            try:
                self._lib.ray_tpu_actor_free(handle)
            except Exception:
                pass
            self._handle = None


def cpp_actor_class(lib_path: str, cls_name: str) -> type:
    """A Python actor class backed by a C++ actor from a task library;
    wrap with ray_tpu_torch.remote(...) and use like any actor.  Path rules
    match cpp_function (relative paths resolve in the worker's cwd)."""
    cls = type(f"Cpp{cls_name}", (_CppActorBase,),
               {"_LIB": lib_path, "_CLS": cls_name})
    return cls


def cpp_function(lib_path: str, func_name: str) -> _CppFunction:
    """A callable running `func_name` from a C++ task library; wrap with
    ray_tpu_torch.remote(...) to run it as a cluster task.  `lib_path` must be
    reachable on the worker's filesystem; a *relative* path is resolved
    in the worker's cwd, so ship the .so via runtime_env working_dir on
    multi-node clusters and pass its in-package relative path."""
    return _CppFunction(lib_path, func_name)


# ------------------------------------------------------------ value codec
def encode(value: Any) -> Any:
    """Python value -> msgpack-representable tree."""
    if isinstance(value, np.ndarray):
        c = np.ascontiguousarray(value)
        return {"__nd__": 1, "dtype": str(c.dtype),
                "shape": list(c.shape), "data": c.tobytes()}
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, (list, tuple)):
        return [encode(v) for v in value]
    if isinstance(value, dict):
        return {k: encode(v) for k, v in value.items()}
    if value is None or isinstance(value, (bool, int, float, str, bytes)):
        return value
    raise TypeError(
        f"value of type {type(value).__name__} cannot cross the "
        f"language boundary (msgpack types + numpy arrays only)")


def decode(value: Any) -> Any:
    """msgpack tree -> Python value (reconstructing tagged ndarrays)."""
    if isinstance(value, dict):
        if value.get("__nd__") == 1:
            return np.frombuffer(
                value["data"], dtype=np.dtype(value["dtype"])
            ).reshape(value["shape"]).copy()
        return {k: decode(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [decode(v) for v in value]
    return value
