"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds: the
"t" RepLKNet widths (or, with widths="b", the cell's own) at 64x96, two
images a batch, three in the pool.

`held_cells.json` holds the entries of the training cells that are held
out of BENCHMARK.json (PERF.md says why); their files are all under the
benchmark's folder, and the tests run them here as they run the others."""

import copy
import json
from pathlib import Path

from harness import cells

HELD = json.loads((Path(__file__).parent / "held_cells.json").read_text())


def bench_with_held() -> dict:
    """BENCHMARK.json with the held cells and their metrics added."""
    bench = copy.deepcopy(cells.manifest())
    for key in ("workloads", "end_to_end", "per_layer"):
        bench[key] += copy.deepcopy(HELD[key])
    return bench


def tiny_cell(workload, widths="t", **options):
    cell = copy.deepcopy(cells.cell(workload, bench_with_held()))
    cell["config"]["options"].update(rep_size=widths, height=64, width=96,
                                     **options)
    cell["traffic"].update(batch=2, pool=3)
    return cell
