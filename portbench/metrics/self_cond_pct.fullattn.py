"""self_cond_pct.fullattn

The share of the traced window's self-conditioned forwards that were
handed the last step's x0 estimate rather than zeros: the program's
counters `GaussianDiffusion.self_cond_fed` and `.self_cond_zero`, read
around the window (facts "self_cond_fed", "self_cond_zero"). One zeros
forward a request, at its first step: 96.0 at 25 steps. Nothing to read
where the program has no such counters.
"""

LAYER = "Sampler loop"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "denoise_step_ms"


def read(outcome):
    fed, zero = outcome.facts.get("self_cond_fed"), outcome.facts.get("self_cond_zero")
    if fed is None or zero is None or fed + zero <= 0:
        return None
    return 100.0 * fed / (fed + zero)
