"""The port's kernel registry (xequinet_torch.ops.cuda_build) on the CPU,
with a stand-in for nvcc: every source builds, one compiler process per
source started together, each with its own time and report; a failed
compile raises; the op modules share one launch counter.  Compiling and
launching the real kernels needs a card (tests/test_torch_gpu.py)."""

import stat
import time

import pytest

from xequinet_torch.ops import cuda_build, fused_message, gather_scatter, gather_scatter_v2

FAKE_NVCC = """#!/bin/sh
# stand-in compiler: sleeps, reports like ptxas on stderr, writes -o's file
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; *.cu) src="$1";; esac
  shift
done
sleep 1
echo "ptxas info    : Used 32 registers ($(basename "$src"))" >&2
case "$src" in *{fail}*) echo "error: stand-in failure" >&2; exit 2;; esac
echo built > "$out"
"""


def _fake_nvcc(tmp_path, monkeypatch, fail="nothing"):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.replace("{fail}", fail))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "BUILD_INFO", {})


def test_build_kernels_builds_every_source_in_parallel(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch)
    t0 = time.perf_counter()
    info = cuda_build.build_kernels()
    wall = time.perf_counter() - t0
    assert sorted(info) == sorted(["message_fwd", "message_bwd", "message_bwd2",
                                   "gather_scatter_v2", "gather_scatter", "bwd_stream_floor"])
    assert wall < 4.5  # six one-second compiles, started together (in turn: 6 s)
    for name, rec in info.items():
        assert 1.0 <= rec["seconds"] < 4.5, name
        assert cuda_build._KERNELS[name][0] in rec["ptxas"]
        assert cuda_build._lib_path(name).read_text() == "built\n"
    # built libraries are kept by the hash of their sources
    assert cuda_build.build_kernels(["gather_scatter"])["gather_scatter"]["seconds"] >= 1.0
    monkeypatch.setattr(cuda_build, "BUILD_INFO", {})
    assert cuda_build.build_kernels(["gather_scatter"])["gather_scatter"]["ptxas"] == "(cached)"


def test_build_kernels_raises_on_a_failed_compile(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, fail="gather_scatter_v2")
    with pytest.raises(RuntimeError, match="nvcc failed for gather_scatter_v2.cu"):
        cuda_build.build_kernels(["message_fwd", "gather_scatter_v2"])
    assert not cuda_build._lib_path("gather_scatter_v2").exists()


def test_op_modules_share_one_launch_counter():
    assert fused_message.LAUNCHES is cuda_build.LAUNCHES
    assert fused_message.reset_launch_counts is cuda_build.reset_launch_counts
    assert fused_message.build_kernels is cuda_build.build_kernels
    assert gather_scatter.launch is gather_scatter_v2.launch is cuda_build.launch
    cuda_build.LAUNCHES["gather_scatter"] += 2
    fused_message.reset_launch_counts()
    assert set(cuda_build.LAUNCHES.values()) == {0}
