"""Tiered against ample serving, checkout by checkout in turns, on one card.

    python -m cxl_speckv_tpu_torch.scripts.tiered_turns ROOT [ROOT ...]

Each ROOT is a checkout of the repository (a directory holding
`chip_smoke.py` beside its `cxl_speckv_tpu_torch` package). In the order
given (two versions in turns: A B B A), a fresh process in ROOT runs the
phases of its `chip_smoke.py` that serve one cell tiered and ample: serve
(Llama-3-8B), serve-int4 and serve-mixed (its first 16 layers), gemma2
(the short cell and the long pair) and mistral. Their lines go to stdout
as they come; at the end one table gives, per run and cell, tiered ÷
ample tok/s and the tiered and ample TTFT p50. Needs a CUDA card; a run
that fails stops the script with its exit code.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

PHASES = """
import chip_smoke as c
from cxl_speckv_tpu_torch.utils.card import card_peaks

smi, name = c.phase_device()
c.phase_build()
launches, cfg, params, prompts = c.phase_serve()
c.phase_serve_schemes(*c.first_layers(cfg, params, c.SCHEME_LAYERS), prompts)
del params
c.phase_gemma(card_peaks(name))
c.phase_mistral()
print(smi, flush=True)
"""

ARM = re.compile(r"^\[(?P<cell>[\w-]+)\] (?P<arm>tiered|ample): .* = "
                 r"(?P<tok_s>[\d.]+) tok/s .*TTFT p50 (?P<ttft>[\d.]+) ms")


def run(root: Path) -> dict:
    """One checkout's serves; returns {cell: {arm: (tok/s, TTFT p50)}}."""
    proc = subprocess.Popen([sys.executable, "-c", PHASES], cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    cells: dict = {}
    for line in proc.stdout:
        print(f"[{root}] {line}", end="", flush=True)
        m = ARM.match(line)
        if m:
            cells.setdefault(m["cell"], {})[m["arm"]] = (
                float(m["tok_s"]), float(m["ttft"]))
    if proc.wait():
        sys.exit(proc.returncode)
    return cells


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", type=Path)
    roots = ap.parse_args().roots
    results = [(root, run(root)) for root in roots]
    print("run | checkout | cell | tiered ÷ ample tok/s | TTFT p50 tiered / "
          "ample ms")
    for i, (root, cells) in enumerate(results):
        for cell, arms in cells.items():
            (tt, ft), (ta, fa) = arms["tiered"], arms["ample"]
            print(f"{i + 1} | {root} | {cell} | {tt / ta:.3f} | "
                  f"{ft:.1f} / {fa:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
