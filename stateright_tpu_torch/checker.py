"""CheckerBuilder / Checker for the port (the counterpart of
`stateright_tpu/checker.py`, reference src/checker.rs:65-578).

The builder carries the model and the options the port supports —
`finish_when`, `target_state_count`, `target_max_depth`, `coverage`,
`sample` (on by default, k = 64, as in the JAX package), `symmetry`,
`pipeline` (on by default: a chain of depth 2, no fusion, as in JAX),
`timeout`, `stage_profile` and the speclint pre-flight (`lint`,
`strict`) — and spawns the device engines:
`spawn_gpu_bfs(**kw)`, the counterpart of `spawn_tpu_bfs`, and
`spawn_gpu_simulation(seed, **kw)`, the counterpart of
`spawn_tpu_simulation`; `engines.multiplex.run_multiplexed` runs many
builders as lanes of one step loop. Options that later slices port
raise `NotImplementedError` naming the slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .core import Expectation, Model
from .has_discoveries import HasDiscoveries
from .path import Path

# Later slices of the port, numbered as in ROADMAP.md Queue 1.
SLICE_PROGLINT = "slice 6c (the program lint over the port's CUDA graphs)"


def not_ported(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch/CUDA engine yet; it comes "
        f"with {slice_name}"
    )


class DiscoveryClassification:
    EXAMPLE = "example"
    COUNTEREXAMPLE = "counterexample"


class CheckerBuilder:
    """Fluent options builder (reference checker.rs:65-288)."""

    def __init__(self, model: Model):
        self.model = model
        self.target_state_count_: Optional[int] = None
        self.target_max_depth_: Optional[int] = None
        self.finish_when_: HasDiscoveries = HasDiscoveries.ALL
        self.coverage_: bool = True
        self.symmetry_fn_: Optional[Any] = None
        self.sample_: bool = True
        self.sample_k_: int = 64  # obs/sample.py DEFAULT_SAMPLE_K
        self.timeout_: Optional[float] = None
        self.pipeline_: bool = True
        self.pipeline_depth_: Optional[int] = None
        self.fuse_eras_: Optional[int] = None
        self.stage_profile_: bool = False
        self.stage_profile_iters_: int = 32
        self.strict_: bool = False
        self.strict_samples_: int = 128
        self.lint_report_: Optional[Any] = None

    def finish_when(self, has_discoveries: HasDiscoveries) -> "CheckerBuilder":
        self.finish_when_ = has_discoveries
        return self

    def target_state_count(self, count: int) -> "CheckerBuilder":
        self.target_state_count_ = count if count > 0 else None
        return self

    def target_max_depth(self, depth: int) -> "CheckerBuilder":
        self.target_max_depth_ = depth if depth > 0 else None
        return self

    def coverage(self, enable: bool = True) -> "CheckerBuilder":
        """Per-action fire counts, the per-depth unique-state histogram and
        per-property evaluation/hit counts (obs/coverage.py), kept on the
        card by the step loop and read once per era."""
        self.coverage_ = enable
        return self

    def sample(self, enable: bool = True, k: int = 64) -> "CheckerBuilder":
        """Deterministic bottom-k fingerprint sampling of the explored
        space (obs/sample.py), on by default at k = 64: a state is
        sampled iff its 64-bit fingerprint is among the k smallest seen,
        so the sample is a pure function of the explored set, equal to
        the JAX engine's. Surfaced by `Checker.space_profile()`."""
        self.sample_ = bool(enable)
        self.sample_k_ = max(1, int(k))
        return self

    def symmetry(self) -> "CheckerBuilder":
        """Symmetry reduction (reference checker.rs:219-227). On a
        TensorModel the engine canonicalizes through the model's batched
        `representative_lanes`, and raises if the model defines none."""
        return self.symmetry_fn(lambda state: state.representative())

    def symmetry_fn(self, representative) -> "CheckerBuilder":
        self.symmetry_fn_ = representative
        return self

    def pipeline(
        self,
        enable: bool = True,
        depth: Optional[int] = None,
        fuse: Optional[int] = None,
    ) -> "CheckerBuilder":
        """Era pipelining on the BFS engine (default on; reference
        `stateright_tpu/checker.py:263-307`). While an era's readback is
        in flight the engine launches up to ``depth`` more eras off the
        still-on-device state (``None`` = 2); the device gate makes an era
        chained past a boundary that needs the host a no-op, so results
        are the serial loop's, bit for bit. ``fuse`` runs up to that
        many eras in one dispatch (``None`` = 1): the next inner era runs
        only after an era that ended on its step budget alone.
        ``enable=False`` forces the serial dispatch -> readback ->
        dispatch loop."""
        self.pipeline_ = bool(enable)
        if depth is not None:
            depth = int(depth)
            if depth < 1:
                raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.pipeline_depth_ = depth
        if fuse is not None:
            fuse = int(fuse)
            if fuse < 1:
                raise ValueError(f"pipeline fuse must be >= 1, got {fuse}")
        self.fuse_eras_ = fuse
        return self

    def stage_profile(self, enable: bool = True, iters: int = 32) -> "CheckerBuilder":
        """Attribute the device engines' era time across the stages of one
        BFS or simulation step (expand / hash / probe / claim / compact /
        ring / canon; hash / cycle / record / expand / choose —
        obs/stageprof.py). After the run, the engine times each stage
        alone at the run's widths (`iters` rounds a dispatch: on the card
        one CUDA graph of the stage's kernels) and scales the measured
        `device_era` time by the resulting shares: `telemetry()["phase_ms"]`
        gains the `stage_*` keys, and the gauges `stage_us_per_step`,
        `stage_profile_iters` and `stage_profile_model_pct` appear. A
        profiler failure sets `stage_profile_error` and leaves the run's
        results alone. The multiplexed lanes refuse it."""
        self.stage_profile_ = enable
        self.stage_profile_iters_ = max(1, int(iters))
        return self

    # -- static analysis (speclint; analysis/) --------------------------------

    def lint(self, samples: int = 256, device=None) -> Any:
        """Run the speclint pre-flight over this builder's model and
        symmetry options WITHOUT launching an engine; tensor models' lane
        programs run on `device` (the card unless it is "cpu").

        Returns an `analysis.AnalysisReport`; its diagnostic counts are
        also exported through `Checker.telemetry()` (as ``lint_<code>``
        counters) by any engine subsequently spawned from this builder.
        """
        from . import tensor as _tensor
        from .analysis import analyze

        # Tensor-backed models canonicalize via representative_lanes (what
        # the device engines run); the host-level symmetry lambda only
        # applies to rich host states.
        tensorish = isinstance(self.model, (_tensor.TensorModel, _tensor.TensorModelAdapter))
        self.lint_report_ = analyze(
            self.model,
            samples=samples,
            symmetry_fn=None if tensorish else self.symmetry_fn_,
            device=device,
        )
        return self.lint_report_

    def strict(self, enable: bool = True, samples: int = 128) -> "CheckerBuilder":
        """Refuse to launch any engine while speclint finds error-severity
        diagnostics: every spawn first runs `lint()` on the engine's own
        device (reusing an explicit earlier `lint()` result) and raises
        `SpecLintError`, before any kernel launch, when the model's
        determinism, device encoding, properties or symmetry are broken.
        `samples` bounds the pre-flight state sample. `run_multiplexed`
        does not lint, as in the JAX package."""
        self.strict_ = enable
        self.strict_samples_ = samples
        return self

    def threads(self, thread_count: int) -> "CheckerBuilder":
        if thread_count != 1:
            raise not_ported("threaded host engines", "a later slice (host engines)")
        return self

    def visitor(self, visitor) -> "CheckerBuilder":
        raise not_ported("checker visitors", "a later slice (host engines)")

    def timeout(self, seconds: float) -> "CheckerBuilder":
        """Stop the run at the first era boundary after `seconds`. The BFS
        engine then sizes its eras adaptively (from 64 steps, doubling
        while an era takes under an eighth of the timeout); the
        simulation engine's eras last at most 64 steps."""
        self.timeout_ = seconds
        return self

    def spawn_gpu_bfs(self, **kw) -> "Checker":
        """Exhaustive BFS over a TensorModel on the card (or, with
        device="cpu", through the kernels' plain versions on the CPU)."""
        from .engines.gpu_bfs import GpuBfsChecker

        return GpuBfsChecker(self, **kw)

    def spawn_sharded_bfs(self, **kw) -> "Checker":
        """Sharded exhaustive BFS over a TensorModel (parallel/mesh.py):
        `devices` shards (an int, or a list of devices) own the states by
        fingerprint, and candidates cross to their owner once a step. One
        process holds its shards on one device; `group=` (a
        torch.distributed process group) spreads them over ranks."""
        from .parallel.mesh import ShardedGpuBfsChecker

        return ShardedGpuBfsChecker(self, **kw)

    def spawn_gpu_simulation(self, seed: int, *, walks: int = 1024, walk_cap: int = 256,
                             sync_steps: int = 1024, device=None) -> "Checker":
        """Batched random-walk simulation over a TensorModel on the card:
        `walks` seeded walks advance one transition a step, each up to
        `walk_cap` states, in eras of at most `sync_steps` steps (or, with
        device="cpu", through the kernels' plain versions on the CPU).
        The walks are the JAX engine's, bit for bit, for the same seed."""
        from .engines.gpu_simulation import GpuSimulationChecker

        return GpuSimulationChecker(
            self, seed, walks=walks, walk_cap=walk_cap, sync_steps=sync_steps, device=device
        )


class Checker:
    """Query interface over a (possibly still running) checking run
    (reference checker.rs:294-578)."""

    def model(self) -> Model:
        return self._model  # type: ignore[attr-defined]

    def state_count(self) -> int:
        raise NotImplementedError

    def unique_state_count(self) -> int:
        raise NotImplementedError

    def max_depth(self) -> int:
        raise NotImplementedError

    def discoveries(self) -> Dict[str, Path]:
        raise NotImplementedError

    def is_done(self) -> bool:
        raise NotImplementedError

    def join(self) -> "Checker":
        return self

    def coverage(self) -> Dict[str, Any]:
        return {}

    def space_profile(self) -> Dict[str, Any]:
        """The run's space profile (obs/sample.py): the bottom-k sample
        rendered into field sketches, depth/action exemplars and
        saturation warnings. Engines without sampling return {}."""
        return {}

    def discovery(self, name: str) -> Optional[Path]:
        return self.discoveries().get(name)

    def discovery_classification(self, name: str) -> str:
        prop = self.model().property(name)
        if prop.expectation in (Expectation.ALWAYS, Expectation.EVENTUALLY):
            return DiscoveryClassification.COUNTEREXAMPLE
        return DiscoveryClassification.EXAMPLE

    def assert_properties(self) -> None:
        for p in self.model().properties():
            if p.expectation in (Expectation.ALWAYS, Expectation.EVENTUALLY):
                self.assert_no_discovery(p.name)
            else:
                self.assert_any_discovery(p.name)

    def assert_any_discovery(self, name: str) -> Path:
        found = self.discovery(name)
        if found is not None:
            return found
        if not self.is_done():
            raise AssertionError(
                f'Discovery for "{name}" not found, but model checking is incomplete.'
            )
        raise AssertionError(f'Discovery for "{name}" not found.')

    def assert_no_discovery(self, name: str) -> None:
        found = self.discovery(name)
        if found is not None:
            raise AssertionError(
                f'Unexpected "{name}" {self.discovery_classification(name)} '
                f"{found}Last state: {found.last_state()!r}\n"
            )
        if not self.is_done():
            raise AssertionError(
                f'Discovery for "{name}" not found, but model checking is incomplete.'
            )

    def assert_discovery(self, name: str, actions: List[Any]) -> None:
        """Assert `actions` forms a valid discovery for property `name`
        (reference checker.rs:519-577)."""
        additional_info: List[str] = []
        found = self.assert_any_discovery(name)
        model = self.model()
        for init_state in model.init_states():
            path = Path.from_actions(model, init_state, actions)
            if path is None:
                continue
            prop = model.property(name)
            if prop.expectation == Expectation.ALWAYS:
                if not prop.condition(model, path.last_state()):
                    return
            elif prop.expectation == Expectation.EVENTUALLY:
                states = path.into_states()
                is_liveness_satisfied = any(
                    prop.condition(model, s) for s in states
                )
                last_actions: List[Any] = []
                model.actions(states[-1], last_actions)
                is_path_terminal = not last_actions
                if not is_liveness_satisfied and is_path_terminal:
                    return
                if is_liveness_satisfied:
                    additional_info.append(
                        "incorrect counterexample satisfies eventually property"
                    )
                if not is_path_terminal:
                    additional_info.append("incorrect counterexample is nonterminal")
            else:  # SOMETIMES
                if prop.condition(model, path.last_state()):
                    return
        extra = f" ({'; '.join(additional_info)})" if additional_info else ""
        raise AssertionError(
            f'Invalid discovery for "{name}"{extra}, but a valid one was found. '
            f"found={found.into_actions()!r}"
        )
