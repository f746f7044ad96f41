"""Elastic layout re-solve: dp x tp x micro-batch planning on resize,
the port's copy of ``elasticdl_tpu/parallel/layout_solver.py``.

The module is pure Python (no torch, no devices), so the port keeps its
own copy and gives the reference's answers exactly: given a world size,
enumerate every feasible ``(dp, tp, micro-batch)`` layout, score each one
(memory-feasible first, then predicted examples/sec) and hand the
winner to ``ElasticDPTrainer.establish`` (``parallel/elastic.py``) as the
``{"data": dp, "model": tp}`` shape of the world's mesh.

Two scoring regimes share one component decomposition (compute + dp
gradient all-reduce + tp activation collectives + fixed dispatch
overhead):

- **static**: a relative FLOP/byte model from the :class:`ModelProfile`
  alone, the correct ordering for layouts of one model on one rig, no
  absolute-time claims.
- **telemetry-fed**: a measured :class:`StepTelemetry` for a known layout
  re-scales the static components (per component when the breakdown is
  present, uniformly otherwise).

Determinism is load-bearing: every process of a consensus world must
solve to the same layout or the ranks lay out different meshes and the
world cannot train. So (a) :func:`solve` is a pure function of its
arguments, (b) establish-time planning (:meth:`LayoutPlanner.axes_for`)
uses only process-identical inputs: the model profile (derived from the
model's structure), the memory budget (``EDL_LAYOUT_MEM_BUDGET_MB``) and
the world size, never local telemetry, and (c) ties break on a quantized
score, then lower tp, then higher dp, then larger micro-batch. Telemetry
feeds only :meth:`LayoutPlanner.candidates`.

The file takes no lock and touches no device: it runs on the establish
path of every process.
"""

import math
import os
from dataclasses import dataclass

# Relative-cost constants for the static regime. These are NOT claims
# about the rig (telemetry calibration supplies real constants); they
# only need plausible RATIOS so the static ordering matches the
# telemetry-fed ordering on one model/rig (tests/test_layout_solver.py
# pins that agreement).
_DEVICE_FLOPS = 1.0e12
_ICI_BYTES_PER_S = 1.0e11
_STEP_OVERHEAD_S = 1.0e-3

DEFAULT_MICROBATCHES = (1, 2, 4, 8, 16, 32)


@dataclass(frozen=True)
class Layout:
    """One parallelism layout: dp width x tp degree, and the per-device
    micro-batch (example rows) the step runs at."""

    dp: int
    tp: int
    microbatch: int

    @property
    def n_devices(self):
        return self.dp * self.tp


def mesh_axes_for(layout):
    """The ``mesh_axes`` dict for a layout — always both axes, tp=1
    included: a single-degree model axis keeps the specs (and therefore
    the pjit dense plane) active, so a dp8xtp1 world is a layout
    CHANGE, not a plane change."""
    return {"data": int(layout.dp), "model": int(layout.tp)}


@dataclass(frozen=True)
class ModelProfile:
    """Deterministic per-model numbers the cost model needs.

    ``replicated_bytes``: per-device bytes of state that replicates
    (parameters + optimizer slots whose specs don't use ``model``).
    ``tp_bytes``: TOTAL bytes of model-sharded state (each device holds
    ``tp_bytes / tp``). ``activation_bytes_per_row``: relative
    activation volume one example row pushes through the tp collectives.
    ``flops_per_row``: relative compute per example row.
    ``tp_degrees``: the degrees the model admits (every model-sharded
    dimension divides; 1 always included)."""

    replicated_bytes: float
    tp_bytes: float
    activation_bytes_per_row: float
    flops_per_row: float
    tp_degrees: tuple = (1,)


@dataclass(frozen=True)
class StepTelemetry:
    """A measured step on a known layout. ``compute_s``/``dp_comm_s``/
    ``tp_comm_s`` are the critical-path phases when available
    (tracetool breakdown); zero means "unmeasured" and the calibration
    falls back to scaling by total step time."""

    layout: Layout
    step_time_s: float
    compute_s: float = 0.0
    dp_comm_s: float = 0.0
    tp_comm_s: float = 0.0


@dataclass(frozen=True)
class ScoredLayout:
    layout: Layout
    feasible: bool
    device_bytes: float
    examples_per_sec: float


def memory_budget_from_env(env=os.environ):
    """Per-device budget in bytes from ``EDL_LAYOUT_MEM_BUDGET_MB``
    (MiB); None when unset/unparseable — every layout memory-feasible."""
    raw = env.get("EDL_LAYOUT_MEM_BUDGET_MB", "")
    try:
        mb = float(raw)
    except ValueError:
        return None
    return mb * (1 << 20) if mb > 0 else None


def device_bytes(layout, profile):
    """Per-device working-set estimate for a layout: replicated state,
    this device's tp shard, and the micro-batch's activations."""
    return (
        float(profile.replicated_bytes)
        + float(profile.tp_bytes) / layout.tp
        + float(profile.activation_bytes_per_row) * layout.microbatch
    )


def _step_components(layout, profile):
    """(compute_s, dp_comm_s, tp_comm_s) under the static constants.

    - compute: per-device rows x flops/row.
    - dp comm: ring-allreduce of this device's gradient bytes,
      ``2 * (dp-1)/dp`` traffic factor; tp shrinks the sharded share.
    - tp comm: per-row activation collectives, ``(tp-1)/tp`` factor.
    """
    rows = layout.microbatch
    compute = rows * float(profile.flops_per_row) / _DEVICE_FLOPS
    grad_bytes = (
        float(profile.replicated_bytes)
        + float(profile.tp_bytes) / layout.tp
    )
    dp_comm = (
        2.0 * grad_bytes * (layout.dp - 1) / layout.dp / _ICI_BYTES_PER_S
        if layout.dp > 1
        else 0.0
    )
    act_bytes = rows * float(profile.activation_bytes_per_row)
    tp_comm = (
        2.0 * act_bytes * (layout.tp - 1) / layout.tp / _ICI_BYTES_PER_S
        if layout.tp > 1
        else 0.0
    )
    return compute, dp_comm, tp_comm


def predict_examples_per_sec(layout, profile, telemetry=None):
    """Predicted global examples/sec for ``layout``.

    With telemetry, the static components re-scale so the measured
    layout's prediction reproduces its measurement: per-component when
    the breakdown is present, else one uniform factor — the uniform
    case preserves the static ordering EXACTLY (a positive scalar on
    every step time), which is the cross-regime agreement the tests
    pin."""
    compute, dp_comm, tp_comm = _step_components(layout, profile)
    overhead = _STEP_OVERHEAD_S
    if telemetry is not None and telemetry.step_time_s > 0:
        m_compute, m_dp, m_tp = _step_components(
            telemetry.layout, profile
        )
        measured_parts = (
            telemetry.compute_s + telemetry.dp_comm_s + telemetry.tp_comm_s
        )
        if measured_parts > 0:
            if telemetry.compute_s > 0 and m_compute > 0:
                compute *= telemetry.compute_s / m_compute
            if telemetry.dp_comm_s > 0 and m_dp > 0:
                dp_comm *= telemetry.dp_comm_s / m_dp
            if telemetry.tp_comm_s > 0 and m_tp > 0:
                tp_comm *= telemetry.tp_comm_s / m_tp
            overhead = max(
                telemetry.step_time_s - measured_parts, 0.0
            )
        else:
            static_step = m_compute + m_dp + m_tp + overhead
            if static_step > 0:
                scale = telemetry.step_time_s / static_step
                compute *= scale
                dp_comm *= scale
                tp_comm *= scale
                overhead *= scale
    step_s = compute + dp_comm + tp_comm + overhead
    if step_s <= 0:
        return 0.0
    return layout.dp * layout.microbatch / step_s


def enumerate_layouts(
    n_devices, profile, microbatches=DEFAULT_MICROBATCHES
):
    """Every (dp, tp, microbatch) with ``dp * tp == n_devices`` and a
    model-admissible tp that divides the world. Deterministic order:
    ascending tp, then ascending micro-batch."""
    n_devices = int(n_devices)
    if n_devices <= 0:
        return []
    degrees = sorted(
        {1}
        | {int(d) for d in (profile.tp_degrees or ()) if int(d) >= 1}
    )
    out = []
    for tp in degrees:
        if n_devices % tp:
            continue
        dp = n_devices // tp
        for mb in microbatches:
            mb = int(mb)
            if mb > 0:
                out.append(Layout(dp=dp, tp=tp, microbatch=mb))
    return out


def _quantized_score(x):
    """Round to 6 significant digits: float noise from a reassociated
    sum must not flip a tie across processes."""
    if x <= 0.0:
        return 0.0
    exp = math.floor(math.log10(x))
    scale = 10.0 ** (exp - 5)
    return round(x / scale) * scale


def _rank_key(scored):
    # feasible first; best quantized score; then the deterministic
    # tie-break: LOWER tp (fewer collectives, simpler failure domain),
    # then higher dp, then larger micro-batch
    return (
        0 if scored.feasible else 1,
        -_quantized_score(scored.examples_per_sec),
        scored.layout.tp,
        -scored.layout.dp,
        -scored.layout.microbatch,
    )


def solve(
    n_devices,
    profile,
    memory_budget=None,
    microbatches=DEFAULT_MICROBATCHES,
    telemetry=None,
):
    """Ranked :class:`ScoredLayout` list for a world of ``n_devices``.

    Memory-feasible layouts rank strictly before infeasible ones (the
    infeasible tail is kept — the caller may report WHY nothing fits).
    A pure function: identical inputs produce the identical ranking on
    every process."""
    scored = [
        ScoredLayout(
            layout=layout,
            feasible=(
                memory_budget is None
                or device_bytes(layout, profile) <= memory_budget
            ),
            device_bytes=device_bytes(layout, profile),
            examples_per_sec=predict_examples_per_sec(
                layout, profile, telemetry
            ),
        )
        for layout in enumerate_layouts(n_devices, profile, microbatches)
    ]
    scored.sort(key=_rank_key)
    return scored


def best(
    n_devices,
    profile,
    memory_budget=None,
    microbatches=DEFAULT_MICROBATCHES,
    telemetry=None,
):
    """The winning feasible layout, or None when no layout exists for
    this world size at all (no admissible tp divides it)."""
    ranked = solve(
        n_devices, profile, memory_budget, microbatches, telemetry
    )
    for s in ranked:
        if s.feasible:
            return s
    return ranked[0] if ranked else None


class LayoutPlanner:
    """The trainer-facing planning surface.

    Wraps a zoo's static ``mesh_axes`` hook: until a model profile is
    fed (:meth:`set_profile`, derived from the first establish's
    abstract state), :meth:`axes_for` answers with the static fallback;
    after that, every resize re-solves the layout. ``axes_for`` is
    deliberately telemetry-blind (see the module docstring);
    :meth:`candidates` ranks the speculation hedge with the latest
    local telemetry, but always leads with the deterministic winner —
    the layout establish will actually pick."""

    def __init__(
        self,
        fallback_axes_fn=None,
        memory_budget=None,
        microbatches=DEFAULT_MICROBATCHES,
    ):
        self.fallback_axes_fn = fallback_axes_fn
        self.memory_budget = (
            memory_budget
            if memory_budget is not None
            else memory_budget_from_env()
        )
        self.microbatches = tuple(int(m) for m in microbatches)
        self.profile = None
        self.telemetry = None
        self.last_plan = None  # the most recent establish-path pick

    def set_profile(self, profile):
        self.profile = profile

    def set_telemetry(self, telemetry):
        """Feed a measured step (speculation ranking only)."""
        self.telemetry = telemetry

    def plan(self, n_devices):
        """Deterministic establish-path pick (no telemetry), or None
        when no profile has been fed / no layout forms."""
        if self.profile is None:
            return None
        pick = best(
            n_devices,
            self.profile,
            self.memory_budget,
            self.microbatches,
        )
        if pick is not None:
            self.last_plan = pick
        return pick

    def axes_for(self, n_devices):
        """``mesh_axes_fn`` drop-in for :class:`ElasticDPTrainer`."""
        pick = self.plan(n_devices)
        if pick is None:
            return (
                self.fallback_axes_fn(n_devices)
                if self.fallback_axes_fn
                else None
            )
        return mesh_axes_for(pick.layout)

    def candidates(self, n_devices, top=2):
        """Top ``top`` distinct (dp, tp) layouts for speculation hints:
        the deterministic winner first, telemetry-ranked hedges after."""
        if self.profile is None:
            return []
        out, seen = [], set()

        def take(scored):
            key = (scored.layout.dp, scored.layout.tp)
            if scored.feasible and key not in seen:
                seen.add(key)
                out.append(scored.layout)

        winner = self.plan(n_devices)
        if winner is not None and winner.feasible:
            take(winner)
        for s in solve(
            n_devices,
            self.profile,
            self.memory_budget,
            self.microbatches,
            telemetry=self.telemetry,
        ):
            if len(out) >= top:
                break
            take(s)
        return out[:top]
