"""Does torch's CPU sqrt return a wrong result on its first call in a process?

Runs ``--runs`` fresh Python processes for each of four variants and counts
those whose first ``torch.sqrt`` differs from ``np.sqrt`` by more than 1e-6
(relative to the largest value); the second call of the same process is
counted too. The variants import only numpy and torch (``none``), the same
with torch held to one thread (``one_thread``), also JAX (``jax``), or also
run one JAX computation before torch's first call (``jaxrun``), as the
parity tests do. Nothing of either package of this repo is imported. The
rate depends on the machine's load: run it beside other work, too.

    JAX_PLATFORMS=cpu python tests/torch_sqrt_first_call.py --runs 30
"""

import argparse
import subprocess
import sys

CHILD = r"""
import sys
variant = sys.argv[1]
import numpy as np
if variant.startswith("jax"):
    import jax, jax.numpy as jnp
import torch
if variant == "one_thread":
    torch.set_num_threads(1)
if variant == "jaxrun":
    jnp.sqrt(jnp.arange(10.0)).block_until_ready()
x = np.random.default_rng(0).uniform(0.01, 400.0, (3, 40, 437)).astype(np.float32)
want = np.sqrt(x)
errs = [float(np.abs(torch.sqrt(torch.from_numpy(x)).numpy() - want).max() / want.max())
        for _ in range(2)]
print(*errs)
"""


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", type=int, default=30)
    args = p.parse_args()
    for variant in ("none", "one_thread", "jax", "jaxrun"):
        first = second = 0
        worst = 0.0
        for _ in range(args.runs):
            out = subprocess.run([sys.executable, "-c", CHILD, variant], check=True,
                                 capture_output=True, text=True).stdout.split()
            e1, e2 = float(out[0]), float(out[1])
            first += e1 > 1e-6
            second += e2 > 1e-6
            worst = max(worst, e1)
        print(f"{variant}: first call off in {first}/{args.runs}, second call off in "
              f"{second}/{args.runs}, worst first-call error {worst:.3e}")


if __name__ == "__main__":
    main()
