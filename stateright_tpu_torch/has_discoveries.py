"""Finish policies: when a checking run may stop early.

Reference: `HasDiscoveries` at src/has_discoveries.rs:6-42.
"""

from __future__ import annotations

from typing import FrozenSet, Iterable, List, Set


class HasDiscoveries:
    """When to finish the checker run, given the set of discovered property names."""

    _kind: str
    _names: FrozenSet[str]

    def __init__(self, kind: str, names: Iterable[str] = ()):  # internal
        self._kind = kind
        self._names = frozenset(names)

    # Constructors mirroring the reference enum variants.
    ALL: "HasDiscoveries"
    ANY: "HasDiscoveries"
    ANY_FAILURES: "HasDiscoveries"
    ALL_FAILURES: "HasDiscoveries"

    @staticmethod
    def all_of(names: Iterable[str]) -> "HasDiscoveries":
        return HasDiscoveries("all_of", names)

    @staticmethod
    def any_of(names: Iterable[str]) -> "HasDiscoveries":
        return HasDiscoveries("any_of", names)

    def matches(self, discoveries: Set[str], properties: List) -> bool:
        """Reference: src/has_discoveries.rs:21-42."""
        kind = self._kind
        if kind == "all":
            return len(discoveries) == len(properties)
        if kind == "any":
            return bool(discoveries)
        if kind == "any_failures":
            return any(
                p.name in discoveries
                for p in properties
                if p.expectation.discovery_is_failure
            )
        if kind == "all_failures":
            return all(
                p.name in discoveries
                for p in properties
                if p.expectation.discovery_is_failure
            )
        if kind == "all_of":
            return all(name in discoveries for name in self._names)
        if kind == "any_of":
            return any(name in discoveries for name in self._names)
        raise ValueError(f"unknown finish policy {kind!r}")

    def device_masks(self, properties: List):
        """Lower this policy to property-index bitmasks for device gates.

        Returns (any_mask, all_mask, all_enabled): the policy matches a
        discovery bitmask `rec` iff `(rec & any_mask) != 0 or
        (all_enabled and (rec & all_mask) == all_mask)` — exactly
        `matches()` over index bitmaps. When the policy references a
        property name that does not exist (an `all_of` that can never
        complete), the all-gate is disabled so the device never exits
        early on it; the host-side `matches()` stays authoritative.
        """
        idx = {p.name: i for i, p in enumerate(properties)}
        all_bits = (1 << len(properties)) - 1
        failure_bits = 0
        for i, p in enumerate(properties):
            if p.expectation.discovery_is_failure:
                failure_bits |= 1 << i
        kind = self._kind
        if kind == "all":
            return 0, all_bits, 1
        if kind == "any":
            return all_bits, 0, 0
        if kind == "any_failures":
            return failure_bits, 0, 0
        if kind == "all_failures":
            return 0, failure_bits, 1
        if kind == "all_of":
            if not all(n in idx for n in self._names):
                return 0, 0, 0  # can never match; disable the device gate
            return 0, sum(1 << idx[n] for n in self._names), 1
        if kind == "any_of":
            return sum(1 << idx[n] for n in self._names if n in idx), 0, 0
        raise ValueError(f"unknown finish policy {kind!r}")

    def __repr__(self) -> str:
        if self._names:
            return f"HasDiscoveries.{self._kind}({sorted(self._names)})"
        return f"HasDiscoveries.{self._kind.upper()}"


HasDiscoveries.ALL = HasDiscoveries("all")
HasDiscoveries.ANY = HasDiscoveries("any")
HasDiscoveries.ANY_FAILURES = HasDiscoveries("any_failures")
HasDiscoveries.ALL_FAILURES = HasDiscoveries("all_failures")
