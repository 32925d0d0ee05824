"""The port's shared kernel launch path (sstem_tpu_torch/kernels/_build.py:
``launch``) and the shape branches of the gather and roll kernels
(kernels/probes.py: ``design``), on the CPU: no nvcc, no GPU, no JAX.

The launch path reads torch's current device and stream through private
calls of ``torch._C``; these tests fail when torch stops declaring them.
The edge-case list (tools/probe_gather.py: ``EDGE_CASES``), which phase 16
of chip_smoke.py holds on the card and tests/test_torch_probes.py against
the JAX probes, must put a case on each side of every branch.
"""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from sstem_tpu_torch.kernels import _build, probes
from sstem_tpu_torch.tools import probe_gather

ROOT = pathlib.Path(__file__).resolve().parent.parent
KERNELS = ROOT / "sstem_tpu_torch" / "kernels"


def test_launch_module_imports_without_nvcc_or_a_gpu():
    code = ("import sstem_tpu_torch.kernels._build as b\n"
            "assert b._lib is None and not b._entries\n"
            "assert b._current_device is None and b._current_stream is None\n"
            "import torch\n"
            "assert not torch.cuda.is_available()\n")
    env = {**os.environ, "PATH": os.path.dirname(sys.executable),
           "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("call", _build.PRIVATE_CALLS)
def test_private_torch_calls_of_the_launch_path_exist(call):
    """Every torch build declares them in torch._C's stub; a CUDA build also
    has them."""
    stub = pathlib.Path(torch.__file__).parent / "_C" / "__init__.pyi"
    assert f"def {call}(" in stub.read_text(), (
        f"torch {torch.__version__} no longer declares torch._C.{call}, which "
        f"sstem_tpu_torch/kernels/_build.py: launch calls")
    if torch.version.cuda:
        assert callable(getattr(torch._C, call))


def test_launch_passes_the_current_stream_and_raises_on_a_cuda_error(
        monkeypatch):
    calls = []

    def entry(*args):
        calls.append(args)
        return args[0]

    class Library:
        @staticmethod
        def sstem_error_string(rc):
            return f"error {rc}".encode()

    monkeypatch.setitem(_build._entries, "sstem_fake", entry)
    monkeypatch.setattr(_build, "_current_device", lambda: 0)
    monkeypatch.setattr(_build, "_current_stream", lambda device: 1000 + device)
    monkeypatch.setattr(_build, "library", lambda: Library)
    _build.launch("sstem_fake", 0, 0, 7, 8)
    assert calls == [(0, 7, 8, 1000)]
    with pytest.raises(RuntimeError,
                       match=r"sstem_fake: CUDA error 700 \(error 700\) at "
                             r"launch"):
        _build.launch("sstem_fake", 0, 700, 7, 8)


def test_every_wrapper_launches_through_the_shared_path():
    for path in sorted(KERNELS.glob("*.py")):
        if path.name in ("__init__.py", "_build.py"):
            continue
        text = path.read_text()
        assert "_build.launch(" in text, path.name
        for private in ("current_stream", "torch.cuda.device(", "library()",
                        "_build.check("):
            assert private not in text, (path.name, private)


def _groups(cols):
    vec = probes.VECTOR_COLS if cols % probes.VECTOR_COLS == 0 else 1
    return cols // vec


def test_edge_cases_put_a_case_on_each_side_of_every_branch():
    edges = probe_gather.EDGE_CASES
    gathers = [c[1:] for c in edges if c[0] == "gather"]
    rolls = [c[1:] for c in edges if c[0] == "roll"]
    assert len(gathers) + len(rolls) == len(edges)
    assert all(8 <= cols <= 300 for _, _, cols in gathers)
    assert all(8 <= cols <= 300 for _, cols, _ in rolls)
    every_gather = list(probe_gather.GATHER_CASES) + gathers
    every_roll = [(r, c) for r, c in probe_gather.ROLL_CASES] + [
        (r, c) for r, c, _ in rolls]
    # kernel and access width: both of each, and the edge list alone holds
    # the 4-byte forms
    assert {probes.design(a, c) for a, _, c in every_gather} == {
        ("rows", 16), ("rows", 4), ("staged", 16), ("staged", 4)}
    assert {probes.design(1, c) for _, c in every_roll} == {
        ("staged", 16), ("staged", 4)}
    assert {probes.design(a, c)[1] for a, _, c in gathers} == {4, 16}
    assert 4 in {probes.design(1, c)[1] for _, c, _ in rolls}
    # axis 0: a ragged last row band and column tile, and whole ones
    axis0 = [(r, c) for a, r, c in every_gather if a == 0]
    assert {r % probes.BAND_ROWS == 0 for r, _ in axis0} == {True, False}
    assert {_groups(c) % probes.TILE_GROUPS == 0 for _, c in axis0} == {
        True, False}
    # the staged kernels: rows of fewer and of more (ragged) column groups
    # than a block has threads
    for staged in ([c for a, _, c in every_gather if a == 1],
                   [c for _, c in every_roll]):
        assert min(map(_groups, staged)) < probes.ROW_THREADS
        assert any(_groups(c) > probes.ROW_THREADS
                   and _groups(c) % probes.ROW_THREADS for c in staged)
        assert max(staged) <= probes.MAX_STAGED_COLS
    # one row on each kernel; shift 0 and shift = cols
    assert {a for a, r, _ in gathers if r == 1} == {0, 1}
    assert any(r == 1 for r, _, _ in rolls)
    assert {s == 0 for _, _, s in rolls} == {True, False}
    assert any(s == c for _, c, s in rolls)


def test_a_row_longer_than_the_staged_plan_is_refused():
    probes._staged_fits("roll_dynamic", probes.MAX_STAGED_COLS)
    with pytest.raises(ValueError, match="at most 57344 columns"):
        probes._staged_fits("roll_dynamic", probes.MAX_STAGED_COLS + 1)
