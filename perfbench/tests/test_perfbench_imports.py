"""No run loads JAX or the JAX package, and the references import nothing of the port."""

import subprocess
import sys

from perfbench.core import spec

PROBE = """
import sys, time, torch
sys.path.insert(0, {root!r})
from perfbench.tests import tiny
from perfbench.core.bench import BANNED, banned_modules
tiny.run(tiny.CELLS[{i}])
assert not banned_modules(), banned_modules()
assert "rnagan_tpu_torch" in sys.modules
print("ok")
"""


def test_tiny_runs_load_no_jax():
    for i in range(len(__import__("perfbench.tests.tiny", fromlist=["CELLS"]).CELLS)):
        out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(spec.ROOT), i=i)], capture_output=True,
                             text=True, timeout=600, cwd=spec.ROOT)
        assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_whole_name_comparison():
    from perfbench.core import bench

    sys.modules.setdefault("rnagan_tpu_torch_probe_only", type(sys)("rnagan_tpu_torch_probe_only"))
    try:
        assert "rnagan_tpu_torch_probe_only" not in bench.banned_modules()
    finally:
        del sys.modules["rnagan_tpu_torch_probe_only"]


def test_references_and_counts_import_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.nets, perfbench.reference.draws, perfbench.reference.train_steps\n"
            "import perfbench.counts.work, perfbench.core.weights\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('rnagan_tpu_torch', 'rnagan_tpu', 'jax'))\n"
            "print(bad)") % str(spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stdout + out.stderr
