import ast
import pathlib

from pb import imports

BENCH = pathlib.Path(__file__).resolve().parent.parent


def test_top_level_names_compared_whole():
    assert imports.forbidden_loaded(["tpu7z_torch", "tpu7z_torch.ops", "jaxtyping",
                                     "numpy", "flaxen"]) == []
    assert imports.forbidden_loaded(["tpu7z.ops.lz4_plane", "jax.numpy", "jaxlib",
                                     "flax", "tpu7z"]) == ["flax", "jax", "jaxlib", "tpu7z"]


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            assert not imports.forbidden_loaded(names), (path, names)
