"""Entry ``sign``: a signer in a closed loop of ``RPSSS.sign``.

The signer holds a key and signs distinct documents, both from the seed;
the prover's random bytes come from a seeded source handed to RPSSS as
``rng=``.  An answer is the signature's bytes.  The reference works out
the public key from the key and verifies each sampled signature in full.
"""

from __future__ import annotations

from starkbench import inputs
from starkbench.reference.field import sample

#: what a configuration of this entry must state
PARAMS = ("expansion_factor", "num_collinearity_checks", "security_level",
          "transition_constraints_degree")


def secret_key(seed: int) -> int:
    """The signer's key, drawn as RPSSS key generation draws one (17 bytes
    sampled into the field)."""
    return sample(inputs.derive(seed, "sk", nbytes=17))


def document(seed: int, k: int) -> bytes:
    """The k-th document signed (k < 0: the warm-up documents)."""
    return b"starkbench document " + inputs.derive(seed, "doc", k, nbytes=24).hex().encode()


def setup(ctx: dict) -> dict:
    from zk_stark_tpu_torch.field import Field
    from zk_stark_tpu_torch.models.rpsss import RPSSS

    cfg, seed = ctx["config"], ctx["seed"]
    rpsss = RPSSS(Field(), **{k: cfg[k] for k in PARAMS},
                  rng=inputs.SeededRng(seed, "sign"), device=ctx["device"])
    state = {"rpsss": rpsss, "stark": rpsss.stark, "seed": seed, "sk": secret_key(seed)}
    for k in range(ctx["traffic"]["warmup_requests"]):
        rpsss.sign(state["sk"], document(seed, -1 - k))
    return state


def request(state: dict, k: int) -> bytes:
    return state["rpsss"].sign(state["sk"], document(state["seed"], k))


def answer(state: dict, k: int) -> bytes:
    return state["answers"][k]


def check(config: dict, seed: int, answers, pool) -> list:
    """(request, reason or None) for each sampled signature."""
    from starkbench.reference import checks

    sk = secret_key(seed)
    jobs = [(config, sk, document(seed, k), sig) for k, sig in answers]
    return [(k, r) for (k, _), r in zip(answers, pool.starmap(checks.check_signature, jobs))]


def control(spec: dict) -> None:
    """The control: the program's own signer at half the colinearity checks
    and half the security level, below the 128 bits the configuration
    states."""
    cfg = spec["config"]
    cfg["num_collinearity_checks"] //= 2
    cfg["security_level"] //= 2
