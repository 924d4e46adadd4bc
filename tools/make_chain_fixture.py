"""Generate the deterministic Rescue-chain proof fixture under tests/fixtures/.

The JAX package proves the chain statement "I know x with chain(x) = y" at
a small configuration with the counter-based SHAKE-256 rng of
``tools/make_fixture.py`` as the prover's randomness, so the proof bytes are
reproducible.  The PyTorch port re-proves with the same rng and asserts byte
equality (``tests/test_torch_chain.py`` on the CPU, ``chip_smoke.py`` on the
card).  The AIR's round-constant polynomials (``_constant_polys()``, uint32
[4, 675, 8]) are saved beside the proof, so the port's tests compare its own
interpolation with the JAX package's without compiling it again.

Configuration: chain length 25 (675 rounds, 676 cycles), expansion 4,
2 checks, security 2.  That gives an omicron domain of 2^12 and a FRI
domain of 2^14, so the fixture goes through NTTs above 2^12 points (the
four-step split) and through 675-coefficient round-constant polynomials
(the long-polynomial evaluator, from 513 coefficients) in the verifier.

Run from the repository root:  python tools/make_chain_fixture.py [OUTDIR]
(OUTDIR defaults to tests/fixtures; about 15 minutes of XLA-CPU compiles).
"""

import hashlib
import json
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

from make_fixture import DetRng  # noqa: E402

from zk_stark_tpu.field import Field  # noqa: E402
from zk_stark_tpu.models.rescue_chain import make_chain_stark  # noqa: E402
from zk_stark_tpu.proof_stream import ProofStream  # noqa: E402
from zk_stark_tpu.stark import VerificationError  # noqa: E402

CONFIG = {
    "chain_length": 25,
    "expansion_factor": 4,
    "num_collinearity_checks": 2,
    "security_level": 2,
}
INPUT = 123456789
RNG_TAG = b"zk-stark-chain-fixture"


def make(outdir: pathlib.Path) -> dict:
    field = Field()
    model, stark = make_chain_stark(
        field,
        CONFIG["chain_length"],
        expansion_factor=CONFIG["expansion_factor"],
        num_collinearity_checks=CONFIG["num_collinearity_checks"],
        security_level=CONFIG["security_level"],
    )
    stark._rng = DetRng(RNG_TAG)
    air = model.air(stark.omicron, stark.omicron_domain_length)
    trace = model.trace(INPUT)
    output = trace[-1][0]
    assert output == model.run(INPUT)
    boundary = model.boundary_constraints(output)

    proof = stark.prove(trace, air, boundary, ProofStream(field))
    stark.verify(air, boundary, ProofStream.deserialize(proof, field))
    try:
        stark.verify(
            air,
            model.boundary_constraints((output + 1) % field.order),
            ProofStream.deserialize(proof, field),
        )
    except VerificationError:
        pass
    else:
        raise AssertionError("a wrong output was accepted")

    outdir.mkdir(parents=True, exist_ok=True)
    (outdir / "chain_proof.bin").write_bytes(proof)
    np.save(outdir / "chain_constant_polys.npy", np.asarray(air._constant_polys()))
    meta = {
        "config": CONFIG,
        "input": str(INPUT),
        "output": str(output),
        "rng_tag": RNG_TAG.decode(),
        "omicron_domain_length": stark.omicron_domain_length,
        "fri_domain_length": stark.fri.domain_length,
        "proof_sha256": hashlib.sha256(proof).hexdigest(),
        "proof_bytes": len(proof),
    }
    (outdir / "chain_meta.json").write_text(json.dumps(meta, indent=2) + "\n")
    return meta


if __name__ == "__main__":
    out = pathlib.Path(sys.argv[1]) if len(sys.argv) > 1 else HERE.parent / "tests" / "fixtures"
    meta = make(out)
    print(json.dumps(meta, indent=2))
