"""What the benchmark's modules may import: no JAX and no JAX package
anywhere (top-level names compared whole: `mdd_tpu_torch` is not
`mdd_tpu`), and nothing of the program in the yardstick."""

import ast
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "mdd_tpu"}
# the reference, the traffic, the weights, the arithmetic and the judge,
# and the model families they call
YARDSTICK = ("reference.py", "corpus.py", "weights.py", "flops.py",
             "compare.py")
FAMILIES = sorted(p.relative_to(BENCH).as_posix()
                  for p in (BENCH / "families").glob("*.py"))


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        bad = top_level_imports(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(BENCH)} imports {bad}"


def test_the_whole_name_is_compared():
    from mdd_bench.run import forbidden_modules
    import sys

    fake = "mdd_tpu_torch_fake_for_test"
    sys.modules[fake] = sys  # a name that starts with mdd_tpu
    try:
        assert fake not in forbidden_modules()
        sys.modules["mdd_tpu.fake_for_test"] = sys
        assert "mdd_tpu.fake_for_test" in forbidden_modules()
    finally:
        sys.modules.pop(fake, None)
        sys.modules.pop("mdd_tpu.fake_for_test", None)


def imported_modules(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return names


def test_the_yardstick_imports_nothing_of_the_program():
    own = {f"mdd_bench.{n[:-3]}" for n in YARDSTICK} | {
        "mdd_bench.ranks", "mdd_bench.manifest"}
    assert "families/cnn_bilstm.py" in FAMILIES
    for name in YARDSTICK + tuple(FAMILIES):
        for mod in imported_modules(BENCH / name):
            assert not mod.startswith("mdd_tpu"), (name, mod)
            if mod.startswith("mdd_bench"):
                assert mod.rsplit(".", 1)[0] in own or mod in own, (name,
                                                                    mod)
