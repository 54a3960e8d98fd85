"""What the A/B tools share (``bwd_ab.py``, ``ssd_ab.py``): each times
this checkout's kernels against another checkout's, alternated in one
process on one card.

Importing this module puts the repo root and ``src/`` on ``sys.path``, so
a tool run as ``python3 tools/<tool>.py`` imports ``chip_smoke``'s
measurement helpers and this checkout's ``repro_torch``.
"""
from __future__ import annotations

import argparse
import importlib.util
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

ORDER = ("this", "other", "other", "this")


def abba(read, rounds: int) -> dict:
    """``read(side)`` for each side in ``ORDER``, ``rounds`` times: every
    reading per side and their median."""
    got = {"this": [], "other": []}
    for _ in range(rounds):
        for side in ORDER:
            got[side].append(read(side))
    return {**got, "median": {k: statistics.median(v)
                              for k, v in got.items()}}


def module(name: str, path: Path):
    """The Python file ``path`` loaded as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_other(root: Path, names) -> dict:
    """The other checkout's ``kernels/<name>/ops.py`` for each of ``names``,
    each bound to that checkout's ``_build`` module (its sources, its shared
    headers, its build directory)."""
    import repro_torch.kernels._build  # noqa: F401 (this side's, to restore)
    pkg = sys.modules["repro_torch.kernels"]
    kdir = root / "src" / "repro_torch" / "kernels"
    build = module("other_build", kdir / "_build.py")
    saved = pkg._build
    pkg._build = sys.modules["repro_torch.kernels._build"] = build
    try:
        return {name: module(f"other_{name}_ops", kdir / name / "ops.py")
                for name in names}
    finally:
        pkg._build = sys.modules["repro_torch.kernels._build"] = saved


def parse_args(doc: str, rounds: int, **counts: int):
    """The tools' command line (``--other DIR``, ``--rounds N``, and an
    integer option for each of ``counts`` with its default), or None where
    no CUDA card is visible. TF32 is turned off for the run."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="root of the other checkout")
    for name, default in dict(rounds=rounds, **counts).items():
        ap.add_argument(f"--{name.replace('_', '-')}", type=int,
                        default=default)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    return args


def print_card():
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no reading", flush=True)
