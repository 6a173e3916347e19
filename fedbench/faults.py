"""Faults planted in the program under the timed path, for the test that
sees ``correct`` come out false and for ``control.py``'s readings of a
fault at a cell's own size. Each fault takes a ``setattr(obj, name,
value)`` that undoes itself (pytest's ``monkeypatch.setattr``, or
``Patches``)."""
from __future__ import annotations


class Patches:
    """A ``setattr`` that remembers what it replaced; ``undo`` restores it."""

    def __init__(self):
        self.saved = []

    def __call__(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self.saved:
            obj, name, value = self.saved.pop()
            setattr(obj, name, value)


def unchanged_step(setattr):
    """Every local AdamW step returns the clients' adapters and state as they were."""
    from repro_torch.core import client

    setattr(client, "adamw_update_many", lambda grads, state, params, **kw: (params, state))


def half_the_batch(setattr):
    """The loss leaves out the second half of each client's rows and takes
    the mean over the rest."""
    from repro_torch.models import model

    real = model.lm_loss

    def lm_loss(logits, labels, mask, clients=None):
        k = clients or 1
        m = mask.reshape(k, -1, mask.shape[-1]).clone()
        m[:, m.shape[1] // 2:] = 0.0
        return real(logits, labels, m.reshape(mask.shape), clients)

    setattr(model, "lm_loss", lm_loss)


def altered_merge(setattr):
    """The server's merge comes back with its text adapter's up-projection 1 % off."""
    from repro_torch.core import aggregation

    real = aggregation.fisher_merge

    def fisher_merge(*a, **kw):
        out = real(*a, **kw)
        out["text"]["up"] = out["text"]["up"] * 1.01
        return out

    setattr(aggregation, "fisher_merge", fisher_merge)


def later_merge_altered(setattr):
    """From the second merge on (the window's rounds), the server's merge
    comes back with its text adapter's up-projection 1 % off; round 0's is
    right."""
    from repro_torch.core import aggregation

    real = aggregation.fisher_merge
    calls = []

    def fisher_merge(*a, **kw):
        out = real(*a, **kw)
        calls.append(1)
        if len(calls) > 1:
            out = dict(out, text=dict(out["text"], up=out["text"]["up"] * 1.01))
        return out

    setattr(aggregation, "fisher_merge", fisher_merge)


def altered_token(setattr):
    """Every other decode step serves each page the next id instead of its token."""
    from repro_torch.serving import engine

    real = engine.ServingEngine._decode

    def _decode(self):
        out = real(self)
        if self.stats["decode_steps"] % 2 == 0:
            out = (out + 1) % self.cfg.vocab_size
        return out

    setattr(engine.ServingEngine, "_decode", _decode)


def half_the_pages(setattr):
    """A decode step leaves out half of the pages (zero embeddings): every
    other page, the odd ones at one step and the even ones at the next, so
    that every request meets the fault."""
    from repro_torch.models import model

    real = model.decode_step
    steps = []

    def decode_step(cfg, params, embed, state, pos, moe_group=None):
        embed = embed.clone()
        embed[len(steps) % 2::2] = 0.0
        steps.append(1)
        return real(cfg, params, embed, state, pos, moe_group)

    setattr(model, "decode_step", decode_step)


def unchanged_cache(setattr):
    """Admission never installs a prefill's KV into its page."""
    from repro_torch.serving import kv_cache

    setattr(kv_cache.KVSlotManager, "write",
            lambda self, slot, page, start_pos: self.pos.__setitem__(slot, start_pos))


TRAIN = (unchanged_step, half_the_batch, altered_merge, later_merge_altered)
SERVE = (altered_token, half_the_pages, unchanged_cache)
