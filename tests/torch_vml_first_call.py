"""Count fresh processes whose first parallel CPU ``tanh`` comes out inexact.

torch evaluates ``tanh`` (and ``exp``, ``log`` and other unary functions) on
the CPU through MKL's vector math library, in chunks of 2048 elements spread
over its OpenMP threads. This script starts fresh Python processes, several at
a time so that they load the host as a parallel test run does. Each makes one
parallel call of ``torch.tanh`` on a [3, 512, 128] float32 tensor (the size of
the gated pool's first activation in ``tests/test_torch_port_ge.py``), and
holds it against float64 numpy. Arms, in the order each process runs them:

  cold   the parallel call is the process's first ``tanh``
  warm   one ``tanh`` on 8 elements (on the calling thread alone) first
  port   ``import multimodal_path_omic_tpu_torch.ops`` first

A process counts as inexact when any element is off by more than 1e-6 (exact
calls are off by 3.2e-8 at most). For each inexact process the script prints
which 24,576-element slices (one a thread, at 8 threads) held the bad
elements, and the error of a second call on the same tensor.

Usage, from the repository root::

    python tests/torch_vml_first_call.py [--rounds 40] [--per-arm 5]

It prints one summary line per arm: processes, inexact processes, worst error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys
import numpy as np
import torch
arm = sys.argv[1]
if arm == "warm":
    torch.tanh(torch.zeros(8))
elif arm == "port":
    import multimodal_path_omic_tpu_torch.ops  # noqa: F401
x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 512, 128), scale=1.2)
                     .astype(np.float32))
ref = np.tanh(x.numpy().astype(np.float64))
err = np.abs(torch.tanh(x).numpy() - ref).reshape(-1)
bad = np.nonzero(err > 1e-6)[0]
slice_len = x.numel() // torch.get_num_threads()
print(json.dumps({"arm": arm, "err": float(err.max()),
                  "again": float(np.abs(torch.tanh(x).numpy() - ref).max()),
                  "threads": torch.get_num_threads(),
                  "bad_slices": sorted({int(i) // slice_len for i in bad})}))
"""

ARMS = ("cold", "warm", "port")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--per-arm", type=int, default=5,
                    help="processes of each arm started together in a round")
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    rows = []
    for _ in range(args.rounds):
        procs = [subprocess.Popen([sys.executable, "-c", CHILD, arm], cwd=root, env=env,
                                  stdout=subprocess.PIPE, text=True)
                 for _ in range(args.per_arm) for arm in ARMS]
        for p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                raise SystemExit(f"a child process failed with exit code {p.returncode}")
            rows.append(json.loads(out.strip().splitlines()[-1]))
    for row in rows:
        if row["err"] > 1e-6:
            print(json.dumps(row))
    for arm in ARMS:
        mine = [r for r in rows if r["arm"] == arm]
        print(f"{arm}: {len(mine)} processes, {sum(r['err'] > 1e-6 for r in mine)} inexact, "
              f"worst error {max(r['err'] for r in mine)!r}")


if __name__ == "__main__":
    main()
