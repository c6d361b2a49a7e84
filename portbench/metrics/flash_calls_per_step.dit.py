"""flash_calls_per_step.dit

Flash-attention calls a denoising step at head dim 72: the change of the
program's counter `flash_attention.launches_d72` (the f32 calls at D 72,
counted at each graph replay) around the traced window (fact
"flash_d72_calls"), over the window's denoising steps. DiT-XL runs one a
block: 28.0, when every attention takes the kernel. Nothing to read where
the program has no such counter.
"""

LAYER = "Kernels"
UNIT = "calls/step"
SOURCE = "program_counter"
MOVES = "denoise_step_ms"


def read(outcome):
    calls, forwards = outcome.facts.get("flash_d72_calls"), outcome.facts.get("forwards")
    if calls is None or not forwards:
        return None
    return calls / forwards
