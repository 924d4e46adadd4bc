"""The comparisons that decide ``correct``: each returns None for an answer
the reference accepts, or the reason it does not.

A configuration file states the parameters and, for a proof, its exact
size; the guarantees checked are the configuration's, whatever the
program ran with.
"""

from __future__ import annotations

from functools import lru_cache

from .field import P, from_montgomery, primitive_root
from .rescue import Rescue
from .stark import Columns, Setup, verify
from .transcript import Reject


@lru_cache(maxsize=None)
def _rescue(security_level: int, m: int, capacity: int, N: int) -> Rescue:
    return Rescue(m, capacity, security_level, N)


def rescue_of(config: dict) -> Rescue:
    r = config["rescue"]
    return _rescue(config["security_level"], r["m"], r["capacity"], r["N"])


def setup_of(config: dict, num_cycles: int, degree: int) -> Setup:
    return Setup(config["expansion_factor"], config["num_collinearity_checks"],
                 config["rescue"]["m"], num_cycles, degree)


def _size_error(config: dict, proof: bytes):
    want = config.get("proof_bytes")
    if want is not None and len(proof) != want:
        return f"{len(proof)} bytes, the configuration's proofs have {want}"
    return None


def check_signature(config: dict, sk: int, document: bytes, signature: bytes):
    """The signature verifies for document under pk = hash(sk)."""
    rescue = rescue_of(config)
    setup = setup_of(config, rescue.N + 1, config["transition_constraints_degree"])
    error = _size_error(config, signature)
    if error:
        return error
    try:
        verify(signature, setup, rescue, [(0, 1, 0), (rescue.N, 0, rescue.hash(sk))],
               document=document)
    except Reject as e:
        return str(e)
    return None


def chain_rounds(config: dict) -> int:
    return config["rescue"]["N"] * config["chain_length"]


def chain_output(config: dict, x: int) -> int:
    return rescue_of(config).chain_output(x, chain_rounds(config))


@lru_cache(maxsize=4)
def _columns(security_level: int, rescue_key: tuple, rounds: int, odl: int) -> Columns:
    return Columns(_rescue(security_level, *rescue_key), rounds, primitive_root(odl))


def chain_columns(config: dict, xs: list[int]) -> list:
    """:meth:`Columns.at` of each point, for the chain's AIR."""
    r = config["rescue"]
    rounds = chain_rounds(config)
    odl = setup_of(config, rounds + 1, 3).omicron_domain_length
    table = _columns(config["security_level"], (r["m"], r["capacity"], r["N"]), rounds, odl)
    return [table.at(x) for x in xs]


def check_chain_proofs(config: dict, xs: list[int], proofs: list[bytes], pool, chunk: int = 8):
    """Each proof proves the chain from its input x to the output the
    reference runs the chain to; the outputs and the constant columns are
    spread over ``pool`` (``multiprocessing`` pool or None)."""
    rescue = rescue_of(config)
    rounds = chain_rounds(config)
    setup = setup_of(config, rounds + 1, 3)
    unique = sorted(set(xs))
    outputs = dict(zip(unique, pool.starmap(chain_output, [(config, x) for x in unique])
                       if pool else [chain_output(config, x) for x in unique]))

    def columns(points):
        if pool is None:
            return chain_columns(config, points)
        parts = [points[i:i + chunk] for i in range(0, len(points), chunk)]
        return [v for part in pool.starmap(chain_columns, [(config, p) for p in parts])
                for v in part]

    reasons = []
    for x, proof in zip(xs, proofs):
        error = _size_error(config, proof)
        if error is None:
            try:
                verify(proof, setup, rescue, [(0, 1, 0), (rounds, 0, outputs[x])],
                       columns=columns)
            except Reject as e:
                error = str(e)
        reasons.append(error)
    return reasons


def _limbs(limbs) -> int:
    if len(limbs) != 8 or any(not 0 <= v < 1 << 16 for v in limbs):
        raise ValueError("not 8 limbs of 16 bits")
    return sum(v << (16 * k) for k, v in enumerate(limbs))


def check_digests(config: dict, answer: dict):
    """Every digest is the hash of its key (both in Montgomery form)."""
    rescue = rescue_of(config)
    bad = []
    for row, key, digest in zip(answer["rows"], answer["keys"], answer["digests"]):
        try:
            sk, pk = _limbs(key), _limbs(digest)
        except ValueError as e:
            bad.append(f"row {row}: {e}")
            continue
        if pk >= P or from_montgomery(pk) != rescue.hash(from_montgomery(sk)):
            bad.append(f"row {row}: digest is not the hash of its key")
    if not answer["rows"]:
        return "no rows"
    return None if not bad else f"{len(bad)} of {len(answer['rows'])} rows wrong, first {bad[0]}"
