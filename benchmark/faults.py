"""Faults a served cell can have, planted under the timed path: each must
turn ``correct`` false (``benchmark/tests``), and ``control.py`` reads them
at a cell's own size."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(*swaps):
    saved = [(module, name, getattr(module, name)) for module, name, _ in swaps]
    try:
        for module, name, make in swaps:
            setattr(module, name, make(getattr(module, name)))
        yield
    finally:
        for module, name, fn in reversed(saved):
            setattr(module, name, fn)


def altered_token():
    """A token altered where it is produced: after every third decode step
    one word (id 1000) is raised far above the rest."""
    from cxrmate_torch.models import bert as bert_mod

    calls = [0]

    def make(step):
        def broken(*a, **kw):
            logits, cache = step(*a, **kw)
            calls[0] += 1
            if calls[0] % 3 == 0:
                logits = logits.clone()
                logits[:, 1000] += 50.0
            return logits, cache
        return broken
    return _patched((bert_mod, "bert_step", make))


def half_the_batch():
    """Half of the batch left out: every other study's images never encoded."""
    from cxrmate_torch.models import encoder_decoder as ed

    def make(encode):
        def broken(model, px, *a, **kw):
            hidden, mask = encode(model, px, *a, **kw)
            hidden = hidden.clone()
            hidden[1::2] = 0
            return hidden, mask
        return broken
    return _patched((ed, "encode_images", make))


def state_unchanged():
    """A decode step that leaves its state as it was: the step's K/V never
    land in the self cache, nor does the beam reorder move it."""
    from cxrmate_torch.models import bert as bert_mod
    from cxrmate_torch.ops import beam_reorder as br

    def make(step):
        def broken(model, cache, *a, **kw):
            copy = bert_mod.DecodeCache([t.clone() for t in cache.self_k],
                                        [t.clone() for t in cache.self_v], cache.cross_k,
                                        cache.cross_v)
            logits, out = step(model, copy, *a, **kw)
            return logits, (cache if out is copy else out)
        return broken
    return _patched((bert_mod, "bert_step", make),
                    (br, "beam_reorder_write", lambda fn: (lambda *a, **kw: None)))


FAULTS = {"altered_token": altered_token, "half_the_batch": half_the_batch,
          "state_unchanged": state_unchanged}
