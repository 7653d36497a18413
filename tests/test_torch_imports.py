"""The port stands on torch and numpy alone: no file of `sfm_tpu_torch` and
not `chip_smoke.py` imports JAX or anything of the JAX package, none imports
triton while the module is imported, and none reaches for a library's fused
attention or for `torch.compile`."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "sfm_tpu_torch")
FILES = sorted(
    [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
     if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")])
FORBIDDEN_ANYWHERE = {"jax", "jaxlib", "sfm_tpu"}
FORBIDDEN_STRINGS = ("scaled_dot_product_attention", "torch.compile")


def _imports(tree, top_level_only):
    nodes = tree.body if top_level_only else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_the_walk_finds_the_package():
    names = {os.path.relpath(f, ROOT) for f in FILES}
    assert "chip_smoke.py" in names
    assert "sfm_tpu_torch/ops/cuda_kernels.py" in names
    assert "sfm_tpu_torch/models/pipeline.py" in names
    assert len(names) >= 20


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(f, ROOT) for f in FILES])
def test_file_imports_nothing_forbidden(path):
    with open(path) as fh:
        src = fh.read()
    tree = ast.parse(src)
    assert not FORBIDDEN_ANYWHERE & set(_imports(tree, False))
    assert "triton" not in set(_imports(tree, True))
    for s in FORBIDDEN_STRINGS:
        assert s not in src


def test_kernel_sources_are_cuda_and_present():
    csrc = os.path.join(PKG, "csrc")
    assert sorted(f for f in os.listdir(csrc) if f.endswith(".cu")) == [
        "detect_filters.cu", "extract_patches.cu", "sad_argmin.cu"]
    for f in os.listdir(csrc):
        if f.endswith(".cu"):
            src = open(os.path.join(csrc, f)).read()
            assert "__global__" in src and 'extern "C"' in src
            assert "cudaGetLastError" in src and "torch/extension.h" not in src


def test_package_turns_tf32_off():
    import torch

    import sfm_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
