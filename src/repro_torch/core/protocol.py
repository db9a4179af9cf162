"""Attack configuration of a BTARD run.

Counterpart of ``repro.core.protocol.AttackConfig``. The legacy host-side
``BTARDProtocol`` simulator of the JAX package is not ported (ROADMAP
queue 1, item 7): the trainer drives ``core.engine`` directly.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class AttackConfig:
    kind: str = "none"  # see core.attacks.ATTACK_NAMES
    start_step: int = 0
    end_step: int = 10**9
    lam: float = 1000.0
    delay: int = 1000
    aggregator_attack: bool = False
    aggregator_scale: float = 0.0  # shift magnitude per corrupted partition
    misreport_s: bool = True  # colluders cancel the Verification-2 checksum
    false_accuse: bool = False  # byz validators slander honest peers
    mprng_abort: bool = False  # byz peers try the abort-bias on MPRNG
