"""Unified serving configuration: ONE dataclass for every serving layer.

Before this module, the serving knobs (blocks, batch, prefix caching,
chunked prefill, fused iteration, pool donation, ragged backend, policy,
tracing, tensor parallelism) threaded through five drifting constructor
kwarg lists — ``PagedModelRunner``, ``LLMEngine``, ``ServingCluster``,
``Workflow``, and the simulator's ``SimConfig`` each re-declared a
subset, and an elastic cluster (instances created at runtime by the
autoscaler) had no single description of "an instance like the others"
to build from.

:class:`ServingConfig` is that single source of truth:

* ``PagedModelRunner.from_config`` / ``LLMEngine.from_config`` /
  ``ServingCluster.from_config`` consume it on the real path;
* ``SimConfig.from_serving_config`` maps it onto the discrete-event
  simulator (``SIM_FIELD_MAP`` below documents the field-for-field
  correspondence; ``tests/test_serving_config.py`` asserts the map is
  total, so a knob added to one side cannot silently not exist on the
  other);
* legacy per-class kwargs are gone: ``Workflow(num_blocks=...)`` raises
  ``TypeError`` pointing here.

Role-typed topology (prefill/decode disaggregation) lives here too:
``roles`` assigns each instance a role — ``"prefill"`` instances run
chunked prefill only and hand finished prompts off, ``"decode"``
instances admit only handed-off requests, ``"general"`` instances do
both (the pre-disaggregation behaviour, and the default).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


# ServingConfig field -> how the simulator consumes it.  Either the name
# of the SimConfig field it maps onto, or a "->field" note for derived
# values.  tests/test_serving_config.py asserts this map covers EVERY
# ServingConfig field and that every plain target is a real SimConfig
# field — real<->sim parity is enforced, not aspirational.
SIM_FIELD_MAP = {
    "num_blocks": "->kv_capacity_tokens",   # num_blocks * block_size
    "block_size": "block_size",
    "max_batch": "max_batch",
    "prefix_caching": "prefix_caching",
    "prefill_chunk_tokens": "prefill_chunk_tokens",
    "fused_iteration": "fused_iteration",
    "donate_pool": "donate_pool",
    "ragged_backend": "->ragged_native",    # native unless a flat lowering
    "policy": "policy",                     # "fcfs" -> "w/o-priority"
    "tracing": "tracing",
    "model_parallel": "tp_degree",
    "n_instances": "n_instances",
    "roles": "roles",
    # -- fault plane (faults.py / recovery.py) --
    "llm_retries": "llm_retries",           # driver-level; carried for parity
    "llm_backoff_s": "llm_backoff_s",       # (sim virtual time can't stall)
    "recovery_retries": "recovery_retries",
    "recovery_backoff_s": "recovery_backoff_s",
    "step_deadline_s": "step_deadline_s",   # real wall-clock; sim carries it
    "slo_e2e_s": "slo_e2e_s",
    "shed_queue_high": "shed_queue_high",
    "shed_kv_high": "shed_kv_high",
    "shed_patience": "shed_patience",
    "handoff_retry_cap": "handoff_retry_cap",
}

ROLES = ("prefill", "decode", "general")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Every serving-layer knob, in one place.

    ``policy`` names the scheduling policy: ``"kairos"`` (orchestrator-
    backed priorities at the balancer AND inside each instance) or
    ``"fcfs"`` (arrival order everywhere).  The simulator additionally
    accepts its baseline policy strings (``"parrot"``, ``"ayo"``, ...)
    passed through verbatim by :meth:`SimConfig.from_serving_config`.

    ``model_parallel`` is the tensor-parallel degree of each instance
    (1 = unsharded); the mesh itself is built by the launcher
    (``ServingCluster.from_config`` / ``on_mesh_slices``), not stored
    here — a config must stay picklable and device-free.
    """

    # -- KV memory ----------------------------------------------------------
    num_blocks: int = 128
    block_size: int = 8
    # -- batching -----------------------------------------------------------
    max_batch: int = 8
    prefill_chunk_tokens: Optional[int] = None
    # -- features -----------------------------------------------------------
    prefix_caching: bool = False
    fused_iteration: bool = True
    donate_pool: bool = True
    ragged_backend: Optional[str] = None   # None = runner backend default
    # -- policy / observability --------------------------------------------
    policy: str = "kairos"
    tracing: bool = False
    # -- topology -----------------------------------------------------------
    model_parallel: int = 1
    n_instances: int = 1
    # roles[i] is instance i's role ("prefill"/"decode"/"general"); None
    # means every instance is "general" — the flat, pre-disaggregation
    # cluster.  A topology with any "prefill" instance must contain a
    # decode-capable one ("decode" or "general") to hand off to.
    roles: Optional[tuple] = None
    # -- fault tolerance (serving/faults.py, serving/recovery.py) -----------
    llm_retries: int = 0                 # Workflow._llm_call TimeoutError
    llm_backoff_s: float = 0.5           # retries + capped exp. backoff
    recovery_retries: int = 3            # crashes a request may survive
    recovery_backoff_s: float = 0.0      # exp. backoff between replays (s)
    step_deadline_s: Optional[float] = None  # straggler fence threshold (s)
    # -- overload shedding (recovery.LoadShedder; None = valve disabled) ----
    slo_e2e_s: Optional[float] = None    # per-request e2e deadline
    shed_queue_high: float = 8.0         # queued-per-instance overload line
    shed_kv_high: float = 0.97           # KV-pressure overload line
    shed_patience: int = 3               # sustained sweeps before valve opens
    # -- disaggregation strand control --------------------------------------
    handoff_retry_cap: int = 4           # probes before permanent colocation

    def __post_init__(self):
        assert self.num_blocks > 0 and self.block_size > 0
        assert self.max_batch > 0 and self.n_instances > 0
        assert self.model_parallel >= 1
        assert (self.prefill_chunk_tokens is None
                or self.prefill_chunk_tokens > 0)
        assert self.llm_retries >= 0 and self.llm_backoff_s >= 0.0
        assert self.recovery_retries >= 0 and self.recovery_backoff_s >= 0.0
        assert self.step_deadline_s is None or self.step_deadline_s > 0.0
        assert self.slo_e2e_s is None or self.slo_e2e_s > 0.0
        assert self.shed_queue_high > 0 and self.shed_patience >= 1
        assert 0.0 < self.shed_kv_high <= 1.0
        assert self.handoff_retry_cap >= 0
        if self.roles is not None:
            # normalize list -> tuple so the frozen config stays hashable
            object.__setattr__(self, "roles", tuple(self.roles))
            assert len(self.roles) == self.n_instances, \
                f"roles {self.roles} must name all {self.n_instances} instances"
            bad = [r for r in self.roles if r not in ROLES]
            assert not bad, f"unknown roles {bad}; choose from {ROLES}"
            if "prefill" in self.roles:
                assert any(r in ("decode", "general") for r in self.roles), \
                    "prefill instances need a decode-capable handoff target"

    # ------------------------------------------------------------- derived
    @property
    def kv_capacity_tokens(self) -> int:
        return self.num_blocks * self.block_size

    def role_of(self, instance_id: int) -> str:
        """Role of instance ``instance_id`` ("general" on flat clusters,
        and for autoscaled instances minted past the declared topology)."""
        if self.roles is None or instance_id >= len(self.roles):
            return "general"
        return self.roles[instance_id]

    @property
    def disaggregated(self) -> bool:
        return self.roles is not None and "prefill" in self.roles

    @property
    def ragged_native(self) -> bool:
        """Whether the configured ragged lowering is the native
        segment-tiled kernel (the flat lowerings re-gather padded
        context; the sim prices the difference)."""
        return not str(self.ragged_backend or "").startswith("flat")

    # ----------------------------------------------------- consumer kwargs
    def runner_kwargs(self) -> dict:
        """Constructor kwargs for :class:`PagedModelRunner` (the mesh, if
        any, is supplied by the caller — it is placement, not config)."""
        return dict(num_blocks=self.num_blocks, block_size=self.block_size,
                    max_batch=self.max_batch,
                    ragged_backend=self.ragged_backend,
                    donate_pool=self.donate_pool)

    def engine_kwargs(self) -> dict:
        """Constructor kwargs for :class:`LLMEngine` (identity, clock,
        policy object, and tracer are per-engine runtime wiring)."""
        return dict(max_batch=self.max_batch,
                    enable_prefix_cache=self.prefix_caching,
                    prefill_chunk_tokens=self.prefill_chunk_tokens,
                    fused_iteration=self.fused_iteration)

    def make_policy(self, orchestrator):
        """Instantiate the scheduling policy object for the real path
        (None = FCFS default for non-kairos policies; the sim's baseline
        policies are constructed by ``Simulation._make_policy``)."""
        from repro_torch.core.scheduler import KairosScheduler
        if self.policy == "kairos":
            return KairosScheduler(orchestrator.priority_score)
        return None

    @property
    def sim_policy(self) -> str:
        """The simulator's name for this policy: the real path's "fcfs"
        (FCFS queue + memory-aware dispatch) is the sim's
        "w/o-priority"; everything else passes through."""
        return "w/o-priority" if self.policy == "fcfs" else self.policy
