"""Models the port checks on the card."""

from .abd import AbdOrderedTensor, AbdTensor
from .increment import IncrementTensor
from .paxos import PaxosTensor, PaxosTensorExhaustive
from .two_phase_commit import TwoPhaseTensor

__all__ = [
    "AbdOrderedTensor",
    "AbdTensor",
    "IncrementTensor",
    "PaxosTensor",
    "PaxosTensorExhaustive",
    "TwoPhaseTensor",
]
