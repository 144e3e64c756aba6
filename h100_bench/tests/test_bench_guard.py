"""No run may load JAX or the JAX package: top-level names compared whole,
so the port (``qqq_tpu_torch``) passes and ``qqq_tpu`` fails; and without a
card a run prints no result."""

import pathlib
import shutil
import subprocess
import sys

from harness import device

BENCH = pathlib.Path(__file__).resolve().parent.parent
REPO = BENCH.parent


def test_top_level_names_are_compared_whole():
    assert device.forbidden(["qqq_tpu_torch", "qqq_tpu_torch.serve.engine",
                             "numpy", "torch", "jaxtyping", "qqq_tpu_x"]) == []
    assert device.forbidden(["qqq_tpu"]) == ["qqq_tpu"]
    assert device.forbidden(["qqq_tpu.models.llama"]) == ["qqq_tpu"]
    assert device.forbidden(["jax", "jax.numpy"]) == ["jax"]
    assert device.forbidden(["jaxlib.xla_client", "flax.linen"]) == [
        "flax", "jaxlib"]


def test_the_run_path_loads_neither_jax_nor_the_jax_package():
    """A fresh process that imports everything a run imports, the program's
    serving path included, has no forbidden module loaded."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run\n"
        "from harness import program, correct, driver, trace, context\n"
        "import reference.qwen2_w4a8\n"
        "import qqq_tpu_torch.serve.engine, qqq_tpu_torch.core.packing\n"
        "from harness import device\n"
        "print(device.forbidden())\n" % (str(REPO), str(BENCH)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "q7g.chat-closed64", "--seed", str(2**31 + 77), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=REPO, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files
    gives no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "q7g.chat-closed64", "--seed", "5", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
