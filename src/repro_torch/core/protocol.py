"""Attack configuration of a BTARD run.

Counterpart of ``repro.core.protocol.AttackConfig``. The JAX package's
host-side ``BTARDProtocol`` wrapper is not ported: the trainer's host
loop (``core.btard_sgd.BTARDTrainer.train_step``) runs the same
``engine.protocol_step`` on the active peers' gradients directly.
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
