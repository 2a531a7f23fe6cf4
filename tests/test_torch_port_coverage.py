"""The port's module map: every module of the JAX package has a counterpart
in the port, or is listed in ROADMAP.md's "Deliberately not ported" with
its reason.  The JAX package's files are read by path with ``ast``;
neither package is imported.

A JAX module ``a/b.py`` maps to the port's ``a/b.py``, except where
RENAMED says otherwise (the vocabulary package is one module in the port).
For the modules of the last slice of the port (queue A: the two BatchNorm
variants, the audio stream, the manifest tools, the native runtime and the
metrics) every public function and class of the JAX module has a
counterpart of the same name.
"""
import ast
import re
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
JAX = REPO / "sbl_for_multilingual_lip_reading_tpu"
PORT = REPO / "sbl_for_multilingual_lip_reading_tpu_torch"
RENAMED = {"vocab/__init__.py": "vocab.py", "vocab/phonemes.py": "vocab.py"}
SAME_NAMES = ("ops/bn_relu.py", "ops/bn_dot.py", "data/audio.py",
              "data/manifest.py", "utils/native.py", "utils/metrics.py")


def _jax_modules():
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py")
                  if "__pycache__" not in p.parts)


def _not_ported():
    """{module path: reason} from ROADMAP.md's "Deliberately not ported"."""
    text = (REPO / "ROADMAP.md").read_text()
    section = text.split("### Deliberately not ported", 1)[1].split("\n###", 1)[0]
    out = {}
    for item in re.split(r"\n- ", section):
        m = re.match(r"\s*`([\w/]+\.py)`[^:]*:\s*(.+)", item, re.S)
        if m:
            out[m.group(1)] = " ".join(m.group(2).split())
    return out


def _public(path: Path):
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def test_every_jax_module_is_ported_or_listed_with_its_reason():
    modules = _jax_modules()
    skipped = {k: v for k, v in _not_ported().items() if k in modules}
    assert all(len(reason.split()) >= 4 for reason in skipped.values()), skipped
    missing = []
    for rel in modules:
        port = PORT / RENAMED.get(rel, rel)
        if port.exists():
            assert rel not in skipped, f"{rel} is ported and listed as not ported"
        elif rel not in skipped:
            missing.append(rel)
    assert not missing, f"JAX modules with no port and no reason: {missing}"
    assert set(skipped) == {"ops/maxpool.py", "utils/compile_cache.py"}


def test_queue_a_modules_keep_every_public_name():
    for rel in SAME_NAMES:
        lost = _public(JAX / rel) - _public(PORT / rel)
        assert not lost, f"{rel}: {sorted(lost)}"
    frontend = _public(PORT / "models/frontend.py")
    assert {"FusedBNAct", "DotBatchNorm", "FastBatchNorm"} <= frontend
    assert (PORT / "csrc" / "sbl_native.cc").exists()
