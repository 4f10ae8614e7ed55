"""Models the port checks on the card."""

from .abd import AbdOrderedTensor, AbdTensor
from .increment import IncrementTensor
from .increment_lock import IncrementLockTensor
from .paxos import PaxosTensor, PaxosTensorExhaustive
from .single_copy import SingleCopyTensor
from .two_phase_commit import TwoPhaseTensor

__all__ = [
    "AbdOrderedTensor",
    "AbdTensor",
    "IncrementLockTensor",
    "IncrementTensor",
    "PaxosTensor",
    "PaxosTensorExhaustive",
    "SingleCopyTensor",
    "TwoPhaseTensor",
]
