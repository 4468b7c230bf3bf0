"""The card's name and power limit, for every measurement line.

Runs `nvidia-smi` as a child process that does not touch JAX, so it never
competes with the measuring process for the card.
"""

import subprocess


def nvidia_smi():
    """One 'name, power limit' line per card, as nvidia-smi gives them, or
    one line saying why there is none."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi unavailable ({type(e).__name__})"]
    lines = [ln.strip() for ln in res.stdout.splitlines() if ln.strip()]
    return lines or [f"nvidia-smi gave nothing (exit {res.returncode})"]
