"""The accelerator that measurements run on.

Every measurement path (bench.py, chip_smoke.py) needs a GPU and names it:
none of them falls back to the CPU, and every number is reported beside
the card's name and power limit, since a card set below its maximum power
runs slower under load.
"""

from __future__ import annotations

import subprocess


def require_gpu():
    """The first JAX device, when it is a GPU. Exits with an error
    otherwise — a number taken on the CPU is no measurement of the card."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {dev.platform} "
                         f"({dev.device_kind}); this needs an NVIDIA GPU")
    return dev


def gpu_name_and_power_limit() -> str:
    """Each card's name and power limit, one line per card, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def device_record() -> dict:
    """What a result is reported beside: platform, device kind, device
    count (as JAX sees them) and nvidia-smi's name and power limit."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "name_and_power_limit": gpu_name_and_power_limit()}
