"""Models the port checks on the card."""

from .two_phase_commit import TwoPhaseTensor

__all__ = ["TwoPhaseTensor"]
