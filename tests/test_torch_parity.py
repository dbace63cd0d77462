"""Port: every public name and positional slot of the JAX package.

For each module of ac3acm_tpu/ the port's module of the same path must
exist and hold:

  (i)   every public top-level function, class and constant, and every
        public method and property of each class, as listed by the JAX
        source's syntax tree (so that names a module imports do not count);
  (ii)  for each such function, method and class constructor, JAX's
        positional parameter names first, in JAX's order, and JAX's
        keyword-only names;
  (iii) for each parameter both packages share, the same default;
  (iv)  no parameter that the port requires (one without a default) and
        JAX's counterpart does not take: a JAX call never lacks an
        argument the port needs.

The exemptions are EXEMPT's, each with its reason; nothing else is.
"""
import ast
import importlib
import inspect
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "ac3acm_tpu")

_VMEM = ("sizes the Pallas kernel's VMEM tiles or window; the port's "
         "kernel (csrc/bitgather.cu) reads rows from global memory through "
         "shared memory and L1 and has no such window")
_INTERPRET = "switches Pallas interpret mode; the port runs CUDA kernels"
_ACCURACY = ("deliberate divergence of the port's default (ROADMAP C6): the "
             "port's fastest path on the card is its default")

# "module path[:name[(slot)]]" -> why the port has no counterpart
EXEMPT = {
    "ops/pallas_steady.py": "the TPU kernel K1; the port's counterpart is "
                            "ops/fused_steady.py (csrc/fused_steady.cu)",
    "utils/cache.py": "JAX's persistent compile cache; the port's kernel "
                      "builds cache themselves (ops/_cuda.py)",
    "ops/filterbank.py:HIGHEST": "TPU matmul precision; the port turns "
                                 "TF32 off and multiplies in FP32",
    "parallel/pipeline.py:fused_gate_ok": "chooses between the TPU kernel's "
                                          "bf16 hi/lo variants; the port's "
                                          "K1 has one variant",
    "ops/bitgather.py:INTERPRET": _INTERPRET,
    "ops/bitgather.py:TS": _VMEM,
    "ops/bitgather.py:TPG": _VMEM,
    "ops/bitgather.py:MEGA": _VMEM,
    "ops/bitgather.py:MEGA_FR": _VMEM,
    "ops/bitgather.py:MEGA_FR_I16": _VMEM,
    "ops/bitgather.py:SPAN_CHECK": "checks the Pallas window's span "
                                   "contract, which the port does not have",
    "ops/bitgather.py:SPAN_VIOLATIONS": "records breaches of the Pallas "
                                        "window's span contract",
    "ops/bitgather.py:reference_extract": "a numpy test oracle; the port's "
                                          "plain versions are the *_ref "
                                          "functions",
    "ops/unpack_device.py:RowPlan.exp_block_slots": "128-slot padding of "
                                                    "the TPU gathers' tiles; "
                                                    "the port's lattice is "
                                                    "unpadded",
    "ops/unpack_device.py:CPLCO_BLOCK_SLOTS": "256-slot padding of the TPU "
                                              "gathers' tiles; the port's "
                                              "lattice is unpadded",
    "ops/unpack_device.py:SEG": "defined in the JAX module and never read",
    "ops/bitgather.py:extract_fields_shared(span_rows)": _VMEM,
    "ops/bitgather.py:extract_fields_shared(per_tile)": _VMEM,
    "parallel/pipeline.py:BatchedDecoder(parser=)": _ACCURACY,
    "host/native.py:SampleDecoder(backend=)": _ACCURACY,
}


def _modules():
    out = []
    for d, _, files in os.walk(JAX_PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), JAX_PKG)
                if rel not in EXEMPT:
                    out.append(rel.replace(os.sep, "/"))
    return sorted(out)


MODULES = _modules()


def _import(pkg, rel):
    name = rel[:-3].replace("/", ".")
    if name == "__init__":
        return importlib.import_module(pkg)
    return importlib.import_module(f"{pkg}.{name.removesuffix('.__init__')}")


def _public(name):
    return not name.startswith("_")


def _targets(node):
    if isinstance(node, ast.Assign):
        for t in node.targets:
            yield from (t.elts if isinstance(t, ast.Tuple) else [t])
    elif isinstance(node, ast.AnnAssign):
        yield node.target


def _listing(rel):
    """[(qualified name, is a class)] of the JAX module's public top-level
    names and its classes' public methods and properties."""
    tree = ast.parse(open(os.path.join(JAX_PKG, rel)).read())
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if _public(node.name):
                out.append((node.name, isinstance(node, ast.ClassDef)))
                if isinstance(node, ast.ClassDef):
                    out += [(f"{node.name}.{b.name}", False)
                            for b in node.body
                            if isinstance(b, ast.FunctionDef)
                            and _public(b.name)]
        else:
            out += [(t.id, False) for t in _targets(node)
                    if isinstance(t, ast.Name) and _public(t.id)]
    return [(q, c) for q, c in out if f"{rel}:{q}" not in EXEMPT]


def _get(module, qual):
    obj = module
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def _pairs(rel):
    """(qualified name, JAX object, port object) for every listed name that
    has a signature on the JAX side."""
    jm, pm = _import("ac3acm_tpu", rel), _import("ac3acm_tpu_torch", rel)
    for qual, _ in _listing(rel):
        j, p = _get(jm, qual), _get(pm, qual)
        if not callable(j):
            continue
        try:
            js = inspect.signature(j)
        except (TypeError, ValueError):
            continue            # ctypes types and C-level exceptions
        yield qual, js, inspect.signature(p)


_POS = (inspect.Parameter.POSITIONAL_ONLY,
        inspect.Parameter.POSITIONAL_OR_KEYWORD)
_VAR = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)


def _slots(rel, qual, sig):
    return [p for p in sig.parameters.values() if p.kind not in _VAR
            and f"{rel}:{qual.split('.')[0]}({p.name})" not in EXEMPT]


@pytest.mark.parametrize("rel", MODULES)
def test_names(rel):
    """(i): the module and each public name of JAX's."""
    pm = _import("ac3acm_tpu_torch", rel)
    missing = []
    for qual, _ in _listing(rel):
        try:
            _get(pm, qual)
        except AttributeError:
            missing.append(qual)
    assert not missing, f"{rel}: the port lacks {missing}"


@pytest.mark.parametrize("rel", MODULES)
def test_positional_slots(rel):
    """(ii): JAX's positional names first, in order; JAX's keyword-only
    names accepted by name."""
    bad = []
    for qual, js, ps in _pairs(rel):
        jpos = [p.name for p in _slots(rel, qual, js) if p.kind in _POS]
        ppos = [p.name for p in ps.parameters.values() if p.kind in _POS]
        jkw = [p.name for p in _slots(rel, qual, js) if p.kind not in _POS]
        if ppos[:len(jpos)] != jpos or not set(jkw) <= set(ps.parameters):
            bad.append((qual, [p.name for p in _slots(rel, qual, js)],
                        list(ps.parameters)))
    assert not bad, f"{rel}: (name, JAX's slots, the port's) {bad}"


def _same(a, b):
    if a is b:
        return True
    try:
        return bool(a == b) and type(a) is type(b)
    except (TypeError, ValueError):
        return False


@pytest.mark.parametrize("rel", MODULES)
def test_defaults(rel):
    """(iii): every shared parameter has JAX's default (or none, as JAX)."""
    bad = []
    for qual, js, ps in _pairs(rel):
        for p in _slots(rel, qual, js):
            q = ps.parameters.get(p.name)
            key = f"{rel}:{qual.split('.')[0]}({p.name}=)"
            if q is None or key in EXEMPT:
                continue
            if not _same(p.default, q.default):
                bad.append((qual, p.name, p.default, q.default))
    assert not bad, f"{rel}: (name, parameter, JAX's, the port's) {bad}"


def test_exemptions_are_live():
    """Each exemption names a JAX module, name or slot that exists, and the
    port does lack the name (a stale exemption would hide nothing)."""
    for key, reason in EXEMPT.items():
        assert reason
        rel, _, rest = key.partition(":")
        assert os.path.exists(os.path.join(JAX_PKG, rel)), key
        if not rest:
            with pytest.raises(ImportError):
                _import("ac3acm_tpu_torch", rel)
            continue
        name, _, slot = rest.partition("(")
        jm, pm = _import("ac3acm_tpu", rel), _import("ac3acm_tpu_torch", rel)
        j = _get(jm, name)
        if not slot:
            with pytest.raises(AttributeError):
                _get(pm, name)
            continue
        slot = slot.rstrip(")")
        js, ps = inspect.signature(j), inspect.signature(_get(pm, name))
        if slot.endswith("="):
            p = slot[:-1]
            assert not _same(js.parameters[p].default,
                             ps.parameters[p].default), key
        else:
            assert slot in js.parameters and slot not in ps.parameters, key


@pytest.mark.parametrize("rel", MODULES)
def test_no_extra_required(rel):
    """(iv): every parameter the port requires, JAX's counterpart takes."""
    bad = []
    for qual, js, ps in _pairs(rel):
        jnames = {p.name for p in js.parameters.values()}
        extra = [p.name for p in ps.parameters.values()
                 if p.kind not in _VAR and p.default is p.empty
                 and p.name not in jnames]
        if extra:
            bad.append((qual, extra))
    assert not bad, f"{rel}: (name, parameters only the port requires) {bad}"
