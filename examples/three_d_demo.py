"""3D octree demo: the generalisation the reference names but never built.

The reference is 2D-only (``N_DIM = 2``, project.cu:28); its report names
the octree / ``N_DIM = 3`` extension (project_report.pdf p.8) and its
``plot_3d.py`` is non-functional as committed.  This script runs the 3D
grouped Barnes-Hut engine end to end, writes the five-column
``time body x y z`` trajectory file (the exact schema plot_3d.py parses),
and renders it with the working 3D plotter.

    python examples/three_d_demo.py [out_dir] [n_bodies]
"""

import os
import sys

from nbody.cli import main as cli


def run(out_dir: str = "three_d_out", n_bodies: int = 4096) -> None:
    os.makedirs(out_dir, exist_ok=True)
    rc = cli(
        [
            "run",
            "--dims", "3",
            "--engine", "barnes_hut",
            "--n-bodies", str(n_bodies),
            "--steps", "10",
            "--theta", "0.5",
            "--save-positions",
            "--save-init",
            "--output-dir", out_dir,
        ]
    )
    if rc:
        raise SystemExit(rc)
    rc = cli(
        [
            "plot",
            "--positions-3d", os.path.join(out_dir, "positions.txt"),
            "--out", os.path.join(out_dir, "plot_3d.png"),
        ]
    )
    if rc:
        raise SystemExit(rc)
    print(f"wrote {out_dir}/positions.txt and {out_dir}/plot_3d.png")


if __name__ == "__main__":
    run(
        sys.argv[1] if len(sys.argv) > 1 else "three_d_out",
        int(sys.argv[2]) if len(sys.argv) > 2 else 4096,
    )
