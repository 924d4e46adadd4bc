"""Probe the NTT stage kernel's cost beyond its arithmetic.

Counterpart of the JAX package's ``tools/ntt_variant_probe.py`` ``main``:
c = 1024 transforms of n = 1024 points, natural rows, run through the four
forms of the stage kernel (``ops/ntt_variants.py``: a, ``csrc/ntt.cu``'s
``ntt_stages_kernel`` itself; b, a stage-major table in shared memory; c,
the first three stages in registers; d, the loads of the next tiles
overlapped with the stages).  Each result must equal the plain transform
of each column and ``ntt.ntt_kernel`` bit for bit; then each is timed with
CUDA events beside the bound of the same work.

    python -m zk_stark_tpu_torch.tools.ntt_variant_probe

runs on the card (and raises without one); ``run(device="cpu", n=16, c=4)``
checks the control flow on the CPU, where every variant is the plain
version and nothing is timed.
"""

from __future__ import annotations

import json
import sys

import torch

from ..field import Field
from ..ops import limbs as L
from ..ops import ntt as N
from ..ops import ntt_variants as V
from . import measure as M

N_POINTS, N_TRANSFORMS = 1024, 1024


def run(n: int = N_POINTS, c: int = N_TRANSFORMS, device="cuda") -> dict:
    """Check a, b, c and d against the plain transform and ``ntt_kernel``,
    time them on the card, print one line per variant; returns, per
    variant, its ``max_abs_err`` (0) and, on the card, ``ms``,
    ``plain_ms``, ``bound_ms`` and ``bound_by``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ntt_variant_probe: CUDA is not available (pass device='cpu')")
    on_card = dev.type == "cuda"
    gen = torch.Generator().manual_seed(5)
    x = torch.randint(0, 1 << 16, (n, c, L.NLIMB), dtype=L.DTYPE, generator=gen)
    x[..., -1] %= L.P_LIMBS[-1]  # below p: a valid Montgomery value
    x = x.to(dev)
    root = Field().primitive_nth_root(n).value
    ref = V.ntt_columns_plain(x, root)
    flat = N.ntt_mont(x, root)
    if not torch.equal(flat, ref):
        raise RuntimeError("ntt_variant_probe: the plain transform differs from ntt_mont")
    if on_card:
        bound = M.ntt_bound(n, M.int32_ops_per_s(), batch=c)
        plain_ms = M.time_ms(lambda: V.ntt_columns_plain(x, root), reps=2, runs=3)
    out = {}
    for which in V.VARIANTS:
        y = V.variant_ntt(which, x, root)
        err = int((y - ref).abs().max()) if y.numel() else 0
        if err or not torch.equal(y, flat):
            raise RuntimeError(f"ntt_variant_probe: variant {which} differs (max abs {err})")
        row = {"max_abs_err": err}
        if on_card:
            row.update(ms=M.time_ms(lambda: V.variant_ntt(which, x, root)),
                       plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1])
            print(f"ntt_variant_{which} n={n} c={c}: bit-exact (plain transform, ntt_kernel); "
                  f"kernel {row['ms']:.4f} ms, plain {plain_ms:.3f} ms, bound "
                  f"{bound[0]:.6f} ms ({bound[1]})", flush=True)
        else:
            print(f"ntt_variant_{which} n={n} c={c}: equals the plain transform on "
                  f"{dev.type} (kernel not run, time not measured)", flush=True)
        out[which] = row
    return out


def main() -> int:
    result = run()
    print(json.dumps({"card": M.card_line(), "variants": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
