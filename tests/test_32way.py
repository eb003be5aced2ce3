"""Reference-cluster-width guard: the sharded SPMD program at 32 shards.

The reference's widest deployment is 32 graph servers
(benchmarks/run-friendster-gcn:6). The suite's virtual mesh is 8-wide
(conftest), so the 32-block halo all_to_all permutation and the 32-way
shared-DP hyb plans would otherwise never run in the suite. This launches
the validation script in a subprocess with its own 32-device CPU mesh; it
asserts
single-vs-32-way loss parity internally (measured delta 2.4e-07)."""

import os
import subprocess
import sys
from pathlib import Path
import pytest

TOOL = Path(__file__).parent.parent / "tools" / "validate_32way.py"


@pytest.mark.slow
def test_32way_loss_parity():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=32"
    env["JAX_PLATFORMS"] = "cpu"
    # Smaller than the committed artifact (suite budget); still >4 real
    # vertices per shard after range partitioning.
    out = subprocess.run(
        [sys.executable, str(TOOL), "--vertices", "32768",
         "--degree", "8", "--epochs", "3"],
        capture_output=True, text=True, timeout=420, env=env)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    assert '"parity_ok": true' in out.stdout, out.stdout
