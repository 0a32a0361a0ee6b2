"""The kernels' shared load-and-launch path (``ops/cuda_build.py``) as far as
it runs without a card, through a stub of each kernel's built library: the
cached load declares every ``extern "C"`` entry point of the source as the
source defines it, a launch plan is made once per card and shape, and a
nonzero return raises with the library's own error string."""

import ctypes
import re

import pytest
import torch

from doa_mpc_tpu_torch.ops import cuda_build, integrators, ip_fused, riccati_fused

# module, prefix of its source's entry points, a plan of it on card -1 (a
# no-op device context on the CPU) for a shape, and for another shape
WRAPPERS = {
    "K1": (ip_fused, "ip_solve",
           lambda nb: ip_fused._plan(-1, 1, nb, 20, 5)),
    "K2": (riccati_fused, "riccati",
           lambda nb: riccati_fused._plan(-1, 4, nb, 20)),
    "K3": (integrators, "irk_step",
           lambda s: integrators._plan(integrators._library(), -1, s, True, torch.float32)),
}
C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float,
           "double": ctypes.c_double, "const char*": ctypes.c_char_p}


class StubLibrary:
    """Stands for a loaded library: each entry point records its calls and
    its declaration (``restype``, ``argtypes``) and returns ``rc``; a plan
    entry fills its outputs, and ``<prefix>_error_string`` names the code."""

    def __init__(self, path=None, rc=0):
        self.path, self.rc, self.calls = path, rc, []

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append(name)
            if name.endswith("_error_string"):
                return f"stub error {args[0]}".encode()
            if name.endswith("_plan") and self.rc == 0:
                for a in args:
                    if isinstance(a, ctypes.Array):
                        a[:] = range(11, 11 + len(a))
                    elif hasattr(a, "_obj"):      # ctypes.byref
                        a._obj.value = 7
            return self.rc

        setattr(self, name, entry)
        return entry


@pytest.fixture
def stub(monkeypatch):
    """Every wrapper's library is a fresh StubLibrary (rc 0; set ``.rc``)
    and nothing is built; the caches are emptied before and after."""
    built = []

    def caches_clear():
        for mod, _, _ in WRAPPERS.values():
            mod._library.cache_clear()
            mod._plan.cache_clear()

    monkeypatch.setattr(cuda_build, "build", lambda source: built.append(source) or source)
    monkeypatch.setattr(ctypes, "CDLL", StubLibrary)
    caches_clear()
    yield built
    caches_clear()


def _c_entry_points(source: str) -> dict:
    """name -> (restype, parameter types) of each ``extern "C"`` function of
    a source."""
    with open(source) as f:
        text = f.read()
    out = {}
    for ret, name, params in re.findall(r'extern "C" ([^(]*?)\s*(\w+)\(([^)]*)\)', text):
        types = [re.match(r"(.*?)\s*\w+$", p.strip()).group(1) for p in params.split(",")
                 if p.strip()]
        out[name] = (C_TYPES[ret.replace(" *", "*")], types)
    return out


def _declared_as(argtype, c_type: str) -> bool:
    """A ctypes argument type against a C parameter type: a pointer as
    ``c_void_p`` or as a pointer to the same C type."""
    if c_type.endswith("*"):
        base = c_type.removeprefix("const ").removesuffix("*").strip()
        return argtype is ctypes.c_void_p or getattr(argtype, "_type_", None) is C_TYPES.get(base)
    return argtype is C_TYPES[c_type]


@pytest.mark.parametrize("kernel", WRAPPERS)
def test_the_cached_load_declares_every_entry_point_as_its_source_does(stub, kernel):
    mod, prefix, _ = WRAPPERS[kernel]
    lib = mod._library()
    assert mod._library() is lib and stub == [mod.KERNEL_SOURCE]   # built and loaded once
    want = _c_entry_points(mod.KERNEL_SOURCE)
    assert {f"{prefix}_plan", f"{prefix}_error_string"} <= set(want)
    assert set(want) == {n for n in vars(lib) if n.startswith(prefix + "_")}
    for name, (restype, params) in want.items():
        fn = getattr(lib, name)
        assert fn.restype is restype, name
        assert len(fn.argtypes) == len(params), name
        for i, (argtype, c_type) in enumerate(zip(fn.argtypes, params)):
            assert _declared_as(argtype, c_type), (name, i, argtype, c_type)


@pytest.mark.parametrize("kernel", WRAPPERS)
def test_a_plan_is_made_once_per_card_and_shape(stub, kernel):
    mod, prefix, plan = WRAPPERS[kernel]
    lib = mod._library()
    first = plan(4)
    assert lib.calls == [f"{prefix}_plan"] + (["irk_step_team", "irk_step_rows_per_block"]
                                              if kernel == "K3" else [])
    if kernel == "K3":
        assert first == integrators.K3Plan(0, 0, 7, 7)
    else:
        assert first == cuda_build.Plan(11, 12, 13, 14, 15)
    del lib.calls[:]
    assert plan(4) is first and lib.calls == []
    plan(3)
    assert lib.calls.count(f"{prefix}_plan") == 1


@pytest.mark.parametrize("kernel", WRAPPERS)
def test_a_failed_plan_raises_with_the_library_error_string(stub, kernel):
    mod, prefix, plan = WRAPPERS[kernel]
    lib = mod._library()
    lib.rc = 2
    with pytest.raises(RuntimeError, match=rf"^{prefix}_plan.* failed.*: stub error 2$"):
        plan(4)
    assert lib.calls == [f"{prefix}_plan", f"{prefix}_error_string"]
    lib.rc = 0
    plan(4)                              # a failure is not cached
    assert lib.calls.count(f"{prefix}_plan") == 2
