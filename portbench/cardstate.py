"""The card's clocks, power and temperature, read with ``nvidia-smi``, and
the host's processor, the cores this process may use and its load.

Read around the window and printed on an earlier line, so that a spread
between runs can be set beside the state of the card and of the host."""

from __future__ import annotations

import os
import shutil
import subprocess

FIELDS = ("index", "name", "clocks.sm", "clocks.mem", "power.draw",
          "power.limit", "temperature.gpu")


def read() -> list | dict:
    """One dict a card, or {"error": ...} where nvidia-smi cannot say."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return {"error": "nvidia-smi not found"}
    try:
        proc = subprocess.run(
            [smi, f"--query-gpu={','.join(FIELDS)}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return {"error": repr(exc)}
    if proc.returncode != 0:
        return {"error": proc.stderr.strip()[-300:]}
    cards = []
    for line in proc.stdout.strip().splitlines():
        values = [v.strip() for v in line.split(",")]
        card = {}
        for key, value in zip(FIELDS, values):
            try:
                card[key] = float(value) if key != "name" else value
            except ValueError:
                card[key] = value
        cards.append(card)
    return cards


def host() -> dict:
    """The host's processor model, the cores this process may run on, and
    the load averages over 1, 5 and 15 minutes."""
    model = None
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return {"cpu": model, "cores": len(os.sched_getaffinity(0)),
            "load": list(os.getloadavg())}
