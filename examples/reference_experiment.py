"""End-to-end reproduction of the reference's experiment pipeline.

The reference workflow (README.md:14-35) is: initialise (or load) a body
cloud -> run the Barnes-Hut simulation writing positions + quadtree dumps
-> render the dumps.  This script does the same through nbody, using
the reference's committed 40,960-body golden fixtures when mounted, and
renders with the scalable plotters (the produced files also feed the
reference's own plot_quadtree.py / plot_2d.py unchanged).

    python examples/reference_experiment.py [out_dir]
"""

import os
import sys


from nbody.cli import main as cli

REF = os.environ.get(
    "NBODY_REFERENCE_DIR", "/root/reference/implementation"
)


def run(out_dir: str = "reference_experiment_out") -> None:
    os.makedirs(out_dir, exist_ok=True)
    args = [
        "run",
        "--engine", "barnes_hut",
        "--steps", "10",
        "--theta", "0.5",
        "--save-positions",
        "--save-tree-dumps",
        "--metrics-csv", "metrics.csv",
        "--output-dir", out_dir,
    ]
    if os.path.exists(os.path.join(REF, "masses_init.txt")):
        args += ["--load-init", REF, "--n-bodies", "40960"]
    else:
        args += ["--n-bodies", "40960", "--save-init"]
    assert cli(args) == 0

    # render (the same files also work with the reference's plotters)
    assert cli([
        "plot", "--quadtree", os.path.join(out_dir, "quadtree_init.txt"),
    ]) == 0
    assert cli([
        "plot", "--quadtree", os.path.join(out_dir, "quadtree_final.txt"),
    ]) == 0
    assert cli([
        "plot", "--positions", os.path.join(out_dir, "positions.txt"),
        "--out", os.path.join(out_dir, "trajectories.png"),
    ]) == 0
    print(f"artifacts in {out_dir}/: positions.txt, quadtree_*.txt(+png), "
          "metrics.csv, trajectories.png")


if __name__ == "__main__":
    run(sys.argv[1] if len(sys.argv) > 1 else "reference_experiment_out")
