"""Multipoint evaluation and interpolation on arbitrary domains (subproduct
trees).

Counterpart of the JAX package's ``ops/multipoint.py``: every tree level is
one batch, so a level costs a fixed number of batched NTT products whatever
its node count.

* zerofier tree: pairwise batched products, bottom up;
* evaluation: a top-down batched remainder sweep; the remainder by each
  (monic) child zerofier comes from the Newton inverse of its reversed
  series (log depth, batched);
* interpolation: barycentric weights v_i / Z'(x_i) (one evaluation sweep of
  the zerofier's derivative, one batched inversion), then a bottom-up
  batched combine r = r_left * Z_right + r_right * Z_left.

Interpolation and remainders are unique, so every result equals the host
Horner and Lagrange references coefficient for coefficient.

A level is ``[m, B, 8]``: coefficients along axis 0, the B nodes as the
batch, the layout ``ops/ntt.py`` transforms natively (the JAX package's
``[B, m, 8]`` and its swaps are not needed).  On the card the transforms
launch ``csrc/ntt.cu`` (one block up to ``MAX_KERNEL_N`` points, the
four-step above), the products, sums and negations ``csrc/limbs.cu``, the
weights' inversion ``csrc/batch_inv.cu``; on CPU tensors the same code runs
their plain versions.  Domains have a power-of-two size here (the levels
stay uniform); ``ops/poly_ops.py`` pads other sizes or dispatches them
elsewhere.
"""

from __future__ import annotations

import functools

import torch

from ..field import Field
from ..utils.bits import is_pow2, next_pow2
from . import limbs as L
from .ntt import MAX_GRID_YZ, MAX_KERNEL_N, ntt_mont, scalar_mul_mont

P = L.P


@functools.lru_cache(maxsize=None)
def _root_for(m: int) -> int:
    return Field().primitive_nth_root(m).value


def _bntt(x: torch.Tensor, root_int: int) -> torch.Tensor:
    """NTT along axis 0 of [m, B, 8] (m a power of two).  Above one block the
    kernel lays the batch on the grid's y or z dimension, so a batch wider
    than ``MAX_GRID_YZ`` goes in several calls."""
    m, b = x.shape[0], x.shape[1]
    if m <= MAX_KERNEL_N or b <= MAX_GRID_YZ:
        return ntt_mont(x, root_int)
    return torch.cat([ntt_mont(x[:, i : i + MAX_GRID_YZ], root_int)
                      for i in range(0, b, MAX_GRID_YZ)], dim=1)


def _pad(x: torch.Tensor, m: int) -> torch.Tensor:
    """x [n, B, 8] cut or zero-padded to m coefficients."""
    if x.shape[0] >= m:
        return x[:m]
    return torch.cat([x, x.new_zeros((m - x.shape[0],) + tuple(x.shape[1:]))])


def _bmul(a: torch.Tensor, b: torch.Tensor, out_len: int) -> torch.Tensor:
    """Batched product [na, B, 8] x [nb, B, 8] -> [out_len, B, 8]: both
    operands transformed in one NTT call, one product, one inverse NTT."""
    assert a.shape[1] == b.shape[1], "operands of a batched product differ in batch"
    m = next_pow2(max(2, a.shape[0] + b.shape[0] - 1))
    root = _root_for(m)
    nb = a.shape[1]
    y = _bntt(torch.cat([_pad(a, m), _pad(b, m)], dim=1), root)
    prod = _bntt(L.mont_mul(y[:, :nb], y[:, nb:]), pow(root, -1, P))
    return _pad(scalar_mul_mont(prod, pow(m, -1, P)), out_len)


def _bseries_inv(q: torch.Tensor, prec: int) -> torch.Tensor:
    """Inverse mod x^prec of each series of q [n, B, 8] with q[0] == 1:
    Newton's v <- v * (2 - q v), log2(prec) steps."""
    v = L.one_mont(q.device).expand(1, q.shape[1], L.NLIMB)
    two = L.int_to_mont(2, q.device)
    cur = 1
    while cur < prec:
        cur = min(2 * cur, prec)
        corr = L.neg_mod(_bmul(q[:cur], v, cur))
        corr[0] = L.add_mod(corr[0], two)
        v = _bmul(v, corr, cur)
    return v


def _brem(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Remainder of each p [np, B, 8] by its MONIC q [d + 1, B, 8] ->
    [d, B, 8]: rev(u) = rev(p) * rev(q)^-1 mod x^(np - d), r = p - q u cut
    to d coefficients."""
    d = q.shape[0] - 1
    n_p = p.shape[0]
    if n_p <= d:
        return _pad(p, d)
    nu = n_p - d
    inv_rq = _bseries_inv(q.flip(0), nu)
    u = _bmul(p.flip(0)[:nu], inv_rq, nu).flip(0)
    return L.sub_mod(p[:d], _bmul(q, u, d))


def zerofier_levels(domain: torch.Tensor, width: int | None = None) -> list[torch.Tensor]:
    """The zerofier tree of a [k, 8] Montgomery domain, bottom up:
    ``levels[l]`` is [2^l + 1, width >> l, 8], the monic zerofiers of
    consecutive blocks of 2^l points; ``levels[-1][:, 0]`` is the whole
    domain's.  ``width`` (a power of two, at least k; k unless given) pads
    the leaves past the domain with the constant 1, so a level's top
    coefficients are zero where its block holds fewer points."""
    k = domain.shape[0]
    width = k if width is None else width
    assert is_pow2(width) and width >= k, f"zerofier_levels: width {width} for {k} points"
    one = L.one_mont(domain.device)
    lvl = domain.new_zeros((2, width, L.NLIMB))
    lvl[0, :k] = L.neg_mod(domain)
    lvl[1, :k] = one
    lvl[0, k:] = one
    levels = [lvl]
    while lvl.shape[1] > 1:
        lvl = _bmul(lvl[:, 0::2], lvl[:, 1::2], 2 * lvl.shape[0] - 1)
        levels.append(lvl)
    return levels


def _eval_sweep(coeffs: torch.Tensor, levels: list[torch.Tensor]) -> torch.Tensor:
    """Top-down remainder sweep: coefficients [n, 8] -> their values [k, 8]
    at the tree's domain, in domain order."""
    r = _brem(coeffs.unsqueeze(1), levels[-1])  # p mod Z: [k, 1, 8]
    for lvl in reversed(levels[:-1]):
        r = _brem(r.repeat_interleave(2, dim=1), lvl)
    return r[0]


def _check_domain(domain: torch.Tensor, name: str) -> int:
    k = domain.shape[0]
    if not is_pow2(k) or tuple(domain.shape) != (k, L.NLIMB):
        raise ValueError(f"{name}: the domain must be [k, 8] with k a power of two, "
                         f"got {tuple(domain.shape)}")
    return k


def evaluate_tree(coeffs: torch.Tensor, domain: torch.Tensor) -> torch.Tensor:
    """Montgomery coefficients [n, 8] evaluated on an arbitrary Montgomery
    domain [k, 8] (k a power of two) -> [k, 8] Montgomery values."""
    _check_domain(domain, "evaluate_tree")
    return _eval_sweep(coeffs, zerofier_levels(domain))


def interpolate_tree(domain: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """The coefficients [k, 8] (degree below k) of the polynomial through
    ``values`` [k, 8] at the distinct points ``domain`` [k, 8] (k a power of
    two), all Montgomery."""
    k = _check_domain(domain, "interpolate_tree")
    if tuple(values.shape) != (k, L.NLIMB):
        raise ValueError(f"interpolate_tree: {tuple(values.shape)} values for {k} points")
    levels = zerofier_levels(domain)
    z = levels[-1][:, 0]  # [k + 1, 8]
    # Z'(x): coefficient j is (j + 1) z_{j+1}
    dz = L.mont_mul(z[1:], L.ints_to_mont(range(1, k + 1), domain.device))
    w = L.mont_mul(values, L.batch_inv(_eval_sweep(dz, levels)))
    r = w.unsqueeze(0)  # [1, k, 8]: the constant interpolants
    for lvl in levels[:-1]:
        m_out = lvl.shape[0] + r.shape[0] - 1
        r = L.add_mod(_bmul(r[:, 0::2], lvl[:, 1::2], m_out),
                      _bmul(r[:, 1::2], lvl[:, 0::2], m_out))
    return r[:, 0]
