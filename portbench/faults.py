"""Faults planted in the program's timed path underneath a run, to show
that `correct` comes out false for each fault a cell can have; the tests
plant them on the CPU, and `calibrate.py --fault` reads them on the card.
No benchmark run plants one.

    unchanged_state  a train step that returns its state unchanged (Adam's
                     moments move, the parameters do not);
    half_batch       a train step's loss, the mean over half of the batch;
    altered_output   a served answer altered where it is produced (one
                     pixel of the sampler's output moved by 0.05);
    half_requests    half of a served batch left out (the second image a
                     copy of the first);
    stale_step       a sampler step that returns its state unchanged (the
                     fourth step's model is handed the third's state).
Each returns a function that takes the fault out again.
"""

import copy


def unchanged_state():
    from fea_tpu_torch.train import trainer

    adam_update = trainer.adam_update

    def unchanged(params, grads, state, lr, b1=0.9, b2=0.99, eps=1e-8):
        _, moved = adam_update(params, grads, state, lr, b1, b2, eps)
        return list(params), moved

    trainer.adam_update = unchanged
    return lambda: setattr(trainer, "adam_update", adam_update)


def half_batch():
    from fea_tpu_torch.train.trainer import Trainer

    loss = Trainer._loss

    def half(self, batch):
        n = batch["geometry"].shape[0] // 2
        return loss(self, {k: v[:n] for k, v in batch.items()})

    Trainer._loss = half
    return lambda: setattr(Trainer, "_loss", loss)


def _sampler(fault):
    from fea_tpu_torch.models.diffusion import GaussianDiffusion

    sample = GaussianDiffusion.sample

    def broken(self, condition, num_steps=None, generator=None, noise=None):
        if fault == "stale_step":
            model, seen = self.model, []

            def stale(x, *args, **kwargs):
                seen.append(x)
                if len(seen) == 4:
                    x.copy_(seen[2])
                return model(x, *args, **kwargs)

            inner = copy.copy(self)
            inner.model = stale
            return sample(inner, condition, num_steps, generator=generator, noise=noise)
        out = sample(self, condition, num_steps, generator=generator, noise=noise)
        if fault == "altered_output":
            out[0, 3, 5, 1] += 0.05
        else:
            out[1] = out[0]
        return out

    GaussianDiffusion.sample = broken
    return lambda: setattr(GaussianDiffusion, "sample", sample)


def altered_output():
    return _sampler("altered_output")


def half_requests():
    return _sampler("half_requests")


def stale_step():
    return _sampler("stale_step")


FAULTS = {f.__name__: f for f in (unchanged_state, half_batch, altered_output, half_requests,
                                  stale_step)}
