"""Command-line speclint: ``python -m stateright_tpu_torch.analysis MODEL``.

MODEL is either a bundled-model shorthand (``NAME`` or ``NAME:ARGS`` with
comma-separated int args, e.g. ``2pc:5``, ``increment:2``, ``abd:2``) or
a dotted constructor path ``package.module:Factory:ARGS`` for user
models. The lane programs run on the card unless ``--device cpu`` is
given. Exit status is the CI contract: 0 = no error-severity findings
(with ``--strict``: no warnings either), 1 = findings, 2 = usage problems.

Examples::

    python -m stateright_tpu_torch.analysis 2pc:5
    python -m stateright_tpu_torch.analysis paxos:2 --samples 512 --json
    python -m stateright_tpu_torch.analysis 2pc:3 --device cpu
    python -m stateright_tpu_torch.analysis mypkg.mymodel:MyTensor:3 --strict
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from typing import Any, Callable, Dict

from ..checker import SLICE_PROGLINT, not_ported
from . import ALL_FAMILIES, analyze


def bundled() -> Dict[str, Callable[..., Any]]:
    """The port's bundled models by shorthand (the JAX package's names
    where it has them)."""
    from ..models import (
        AbdOrderedTensor,
        AbdTensor,
        IncrementLockTensor,
        IncrementTensor,
        PaxosTensor,
        PaxosTensorExhaustive,
        SingleCopyTensor,
        TwoPhaseTensor,
    )

    return {
        "2pc": TwoPhaseTensor,
        "abd": AbdTensor,
        "abd-ordered": AbdOrderedTensor,
        "increment": IncrementTensor,
        "increment-lock": IncrementLockTensor,
        "paxos": PaxosTensor,
        "paxos-exhaustive": PaxosTensorExhaustive,
        "single-copy": SingleCopyTensor,
    }


def _args(part: str):
    return [int(a) for a in part.split(",")] if part else []


def resolve_model(spec: str):
    """``NAME[:ARGS]`` (bundled) or ``pkg.module:Factory[:ARGS]``; a name
    that resolves to nothing is a usage error (exit 2)."""
    models = bundled()
    parts = spec.split(":")
    if parts[0] in models:
        return models[parts[0]](*_args(parts[1] if len(parts) > 1 else ""))
    if "." in parts[0] and len(parts) >= 2:
        try:
            factory = getattr(importlib.import_module(parts[0]), parts[1])
        except (ImportError, AttributeError) as exc:
            print(f"cannot resolve {spec!r}: {exc}", file=sys.stderr)
            raise SystemExit(2) from exc
        return factory(*_args(parts[2] if len(parts) > 2 else ""))
    print(
        f"unknown model {spec!r}; bundled: {', '.join(sorted(models))} "
        "(append :ARGS, e.g. 2pc:5), or pkg.module:Factory:ARGS",
        file=sys.stderr,
    )
    raise SystemExit(2)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m stateright_tpu_torch.analysis",
        description="pre-flight static analysis of a model "
        "(determinism, device compatibility, properties, symmetry)",
    )
    parser.add_argument("model", help="bundled shorthand (2pc:5) or pkg.module:Factory:ARGS")
    parser.add_argument("--samples", type=int, default=256,
                        help="breadth-first state-sample budget (default 256)")
    parser.add_argument("--families", default=",".join(ALL_FAMILIES),
                        help=f"comma-separated rule families (default: all of {','.join(ALL_FAMILIES)})")
    parser.add_argument("--json", action="store_true", help="emit the report as one JSON object")
    parser.add_argument("--strict", action="store_true",
                        help="exit 1 on warnings too, not only on error findings")
    parser.add_argument("--device", default=None,
                        help="where the lane programs run: cuda (the default) or cpu")
    parser.add_argument("--program", action="store_true",
                        help="the STR6xx program lint (not ported: exits 2)")
    parser.add_argument("--write-budgets", action="store_true",
                        help="the STR604 op budgets (not ported: exits 2)")
    args = parser.parse_args(argv)
    families = [f.strip() for f in args.families.split(",") if f.strip()]
    if args.program or args.write_budgets or "program" in families:
        print(not_ported("the program lint (STR6xx: --program, --write-budgets)", SLICE_PROGLINT),
              file=sys.stderr)
        return 2
    unknown = sorted(set(families) - set(ALL_FAMILIES))
    if unknown:
        print(f"unknown rule families {unknown}; available: {ALL_FAMILIES}", file=sys.stderr)
        return 2
    from ..engines.gpu_bfs import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as exc:
        print(exc, file=sys.stderr)
        return 2
    model = resolve_model(args.model)
    report = analyze(model, samples=args.samples, families=families, device=device)
    print(json.dumps(report.to_dict(), indent=2) if args.json else report.format())
    if not report.ok or (args.strict and report.warnings):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
