"""host_inputs_ms.sign: the program's stage ``host_inputs`` (its
``StageTimer``, which synchronises the card at the stage's ends), mean ms
a request."""


def read(run):
    return run.stage_mean_ms("host_inputs")
