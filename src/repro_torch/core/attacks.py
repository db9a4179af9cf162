"""The paper's attack zoo (§4.1): what Byzantine peers send instead of their
honest gradients, and the aggregator-side shift.

Counterpart of ``repro.core.attacks``. Every gradient attack maps the
stacked ``(n, d)`` gradients and the Byzantine mask to new gradients;
``apply_attack`` selects one by registry index. Label flip happens at
gradient time (it needs the loss), so here it is the identity.
``hon_mask`` marks the rows whose statistics the collusion attacks (IPM,
ALIE) may read.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.core.norms import vector_norm


def _hon(byz_mask, hon_mask):
    return ~byz_mask if hon_mask is None else hon_mask


def _lam(lam, grads):
    return torch.tensor(lam, dtype=grads.dtype, device=grads.device)


def sign_flipped(grads, lam=1000.0):
    """-lam times ``grads``: what a sign-flipping attacker sends."""
    return -_lam(lam, grads) * grads


def sign_flip(grads, byz_mask, *, lam=1000.0, **_):
    """Each attacker sends -lam times its true gradient."""
    return torch.where(byz_mask[:, None], sign_flipped(grads, lam), grads)


def random_direction(grads, byz_mask, *, key, lam=1000.0, **_):
    """All attackers send a large common random vector."""
    v = prng.normal(key, (grads.shape[1],)).to(grads.dtype)
    v = v / torch.clamp(vector_norm(v), min=1e-30)
    scale = _lam(lam, grads) * vector_norm(grads, dim=1).mean()
    return torch.where(byz_mask[:, None], (scale * v)[None, :], grads)


def delayed_gradient(grads, byz_mask, *, delayed, **_):
    """Attackers send their real gradients from D steps ago."""
    return torch.where(byz_mask[:, None], delayed, grads)


def ipm(grads, byz_mask, *, epsilon=0.6, hon_mask=None, **_):
    """Inner-product manipulation: attackers send -epsilon * honest mean."""
    hon = _hon(byz_mask, hon_mask)
    denom = torch.clamp(hon.sum(), min=1)
    mu = (grads * hon[:, None]).sum(0) / denom
    return torch.where(byz_mask[:, None], (-epsilon * mu)[None, :], grads)


def alie(grads, byz_mask, *, hon_mask=None, **_):
    """A Little Is Enough: attackers send mu - z_max * sigma with
    z_max = Phi^{-1}((n - b - s) / (n - b)), s = floor(n/2) + 1 - b."""
    n = grads.shape[0]
    b = byz_mask.sum()
    hon = _hon(byz_mask, hon_mask)
    denom = torch.clamp(hon.sum(), min=1)
    mu = (grads * hon[:, None]).sum(0) / denom
    var = (((grads - mu[None]) ** 2 * hon[:, None]).sum(0)
           / torch.clamp(denom - 1, min=1))
    sigma = torch.sqrt(var)
    s = n // 2 + 1 - b
    q = torch.clamp((n - b - s) / torch.clamp(n - b, min=1), 1e-4, 1 - 1e-4)
    z_max = torch.special.ndtri(q.to(torch.float32))
    mal = mu - z_max * sigma
    return torch.where(byz_mask[:, None], mal[None, :], grads)


def label_flip(grads, byz_mask, **_):
    """Marker: handled at gradient computation (loss with flipped labels)."""
    return grads


ATTACK_NAMES = (
    "none",
    "sign_flip",
    "random_direction",
    "label_flip",
    "delayed_gradient",
    "ipm_01",
    "ipm_06",
    "alie",
)
ATTACK_INDEX = {name: i for i, name in enumerate(ATTACK_NAMES)}

_REGISTRY = (
    lambda g, m, **_: g,
    sign_flip,
    random_direction,
    label_flip,
    delayed_gradient,
    lambda g, m, **kw: ipm(g, m, epsilon=0.1, **kw),
    lambda g, m, **kw: ipm(g, m, epsilon=0.6, **kw),
    alie,
)


def attack_index(kind: str) -> int:
    """Registry index for an attack name (raises KeyError on unknown)."""
    return ATTACK_INDEX[kind]


def rejoin_under_new_key(slot, leave_step, rejoin_step, identity=None):
    """The churn adversary: a (typically already banned) peer vacates its
    slot and rejoins it, going on with whatever gradient attack its slot's
    ``byz_mask`` entry encodes. ``identity=None`` is the NEW-KEY variant:
    ``engine.encode_events`` mints a fresh identity, so the ban ledger
    does not refuse it at admission and the probation spot-check
    (``core.sybil``) must catch it; the original identity gives the
    SAME-KEY variant, refused at admission from the identity ban ledger.
    Returns an event schedule for ``init_state(events=...)``."""
    join = ((rejoin_step, "join", slot) if identity is None
            else (rejoin_step, "join", slot, identity))
    return [(leave_step, "leave", slot), join]


def apply_attack(idx, grads, byz_mask, *, key, lam=1000.0, delayed=None,
                 hon_mask=None):
    """Apply registry attack ``idx`` to the stacked gradients.

    byz_mask: rows the attack REPLACES; hon_mask: rows collusion statistics
    may read; delayed: (n, d) rows for delayed_gradient."""
    if delayed is None:
        delayed = torch.zeros_like(grads)
    return _REGISTRY[int(idx)](grads, byz_mask, key=key, lam=lam,
                               delayed=delayed, hon_mask=hon_mask)


def aggregator_shift_all(agg, corrupt_mask, key, scale):
    """Rows of ``agg`` (n_parts, part) where ``corrupt_mask`` is set receive
    a unit random shift (one direction per partition) times ``scale``."""
    noise = prng.normal(key, tuple(agg.shape))
    noise = noise / torch.clamp(
        vector_norm(noise, dim=1, keepdim=True), min=1e-30)
    return torch.where(corrupt_mask[:, None], agg + scale * noise, agg)
