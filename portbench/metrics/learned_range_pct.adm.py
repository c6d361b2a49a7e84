"""learned_range_pct.adm

The share of the traced window's denoising steps whose update drew its
variance from the model's output: the program's counters
`GaussianDiffusion.learned_range_steps` and `.final_steps` (the t = 0
steps, which add no noise), read around the window (facts
"learned_range_steps", "final_steps"). One final step a request: 96.0 at
25 steps. Nothing to read where the program has no such counters.
"""

LAYER = "Sampler loop"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "denoise_step_ms"


def read(outcome):
    learned, final = outcome.facts.get("learned_range_steps"), outcome.facts.get("final_steps")
    if learned is None or final is None or learned + final <= 0:
        return None
    return 100.0 * learned / (learned + final)
