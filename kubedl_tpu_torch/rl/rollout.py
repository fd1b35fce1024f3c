"""RolloutClient: prompt groups through the fleet as a rollout tenant.

The generation half of the flywheel (docs/rl.md). Rollouts are ordinary
fleet traffic — every submission goes through the serving router under
the RLJob's dedicated tenant, so the EXISTING arbitration machinery
decides who wins contended capacity:

* the tenant maps to its own low-priority queue
  (``api/queue.QueueSpec.tenants`` — the same attribution the slice
  scheduler routes jobs by), and the router's per-tenant fairness
  spills rollouts off a hot replica once their queue holds its fair
  share there: a flash crowd squeezes rollouts automatically;
* conversely an idle fleet feeds them: nothing here reserves capacity,
  rollouts simply queue like any tenant and drain when lanes free up;
* the shared system prompt registers as a PINNED prefix on every
  replica, so group members re-use its KV blocks instead of
  re-prefilling it ``group_size`` times per prompt.

Every generation is pinned to ONE policy version (the router filters
replicas by ``policy_version``): a rollout batch whose completions came
from different weights has no well-defined behavior policy, and the
GRPO ratio would be fiction. Completed streams + rewards assemble into
the exact update batch :func:`kubedl_tpu_torch.train.grpo.rollout_batch`
produces (shared :func:`~kubedl_tpu_torch.train.grpo.assemble_batch`).

Copied from ``kubedl_tpu/rl/rollout.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from ..train.grpo import GRPOConfig, assemble_batch

#: the flywheel's tenant name: queue specs route it, the router
#: attributes its placements, the fairness spill squeezes it
ROLLOUT_TENANT = "rollout"


@dataclass
class RolloutBatch:
    """One versioned rollout batch: everything the learner needs plus
    the provenance the staleness contract is built on."""

    #: the policy version that generated EVERY completion in ``batch``
    version: int
    #: the GRPO update batch (``assemble_batch`` output; no
    #: ``ref_logps`` yet — the learner scores the frozen reference)
    batch: dict
    prompts: int
    completions: int
    #: completion tokens generated (the throughput-floor unit)
    tokens: int
    mean_reward: float


class RolloutClient:
    """Submit prompt groups through a fleet router; harvest versioned
    rollout batches.

    One generation in flight at a time (the flywheel is a loop, not a
    pipeline: the learner consumes a batch before the next submits —
    staleness stays measurable instead of unbounded). Drive completion
    externally: the replay/bench tick ``fleet.step()``; a live fleet's
    background loops drain the queues on their own.
    """

    def __init__(self, router, reward_fn: Callable,
                 cfg: Optional[GRPOConfig] = None,
                 tenant: str = ROLLOUT_TENANT,
                 system_prompt: Sequence[int] = (),
                 max_new_tokens: int = 16, pad_id: int = 0):
        self.router = router
        self.reward_fn = reward_fn
        self.cfg = cfg or GRPOConfig()
        self.tenant = tenant
        self.system_prompt = list(system_prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.pad_id = pad_id
        #: completion tokens harvested over the client's lifetime (the
        #: flywheel's throughput-floor numerator)
        self.tokens_total = 0
        self.batches_built = 0
        self._groups: list = []       # flat prompt rows, group-major
        self._reqs: list = []         # one Request per row
        self._n_prompts = 0
        self._version: Optional[int] = None

    # -- prefix -----------------------------------------------------------

    def pin_prefix(self) -> int:
        """Register the shared system prompt as a PINNED prefix on every
        active replica (pinned = exempt from least-recently-hit
        eviction: the flywheel re-uses it for the whole job, it must
        not churn out under user prefixes). Idempotent; call again
        after scale-ups. Returns how many replicas newly registered."""
        if not self.system_prompt:
            return 0
        fresh = 0
        for rep in self.router.fleet.active():
            if not rep.engine.has_prefix(self.system_prompt):
                rep.engine.register_prefix(list(self.system_prompt),
                                           pinned=True)
                fresh += 1
        return fresh

    # -- generation -------------------------------------------------------

    def submit_prompts(self, prompts: Sequence[Sequence[int]],
                       version: int) -> int:
        """Submit ``group_size`` completions per prompt, all pinned to
        ``version`` and attributed to the rollout tenant. Per-request
        sampling overrides force plain temperature-1 sampling so the
        engines' full-softmax logprobs ARE the behavior policy,
        whatever each engine's own GenerateConfig says. Returns the
        number of requests submitted."""
        if self._reqs:
            raise RuntimeError(
                "previous rollout generation still in flight "
                f"({self.pending()} request(s)); harvest it first")
        sp = self.system_prompt
        groups = [sp + list(p) for p in prompts
                  for _ in range(self.cfg.group_size)]
        prefix = sp if sp else None
        reqs = []
        for row in groups:
            req, _rep = self.router.submit(
                row, self.max_new_tokens, tenant=self.tenant,
                prefix=prefix, version=version, logprobs=True,
                temperature=1.0, top_k=0, top_p=1.0)
            reqs.append(req)
        self._groups, self._reqs = groups, reqs
        self._n_prompts = len(prompts)
        self._version = version
        return len(reqs)

    def pending(self) -> int:
        """Requests submitted but not yet finished."""
        return sum(1 for r in self._reqs if not r.done.is_set())

    def try_harvest(self) -> Optional[RolloutBatch]:
        """The versioned rollout batch once EVERY stream of the current
        generation finished; None while any is still decoding (partial
        batches would bias toward short completions)."""
        if not self._reqs or self.pending():
            return None
        outs = [(r.result(), list(r.logprobs)) for r in self._reqs]
        batch = assemble_batch(self._groups, outs, self._n_prompts,
                               self.reward_fn, cfg=self.cfg,
                               pad_id=self.pad_id)
        tokens = sum(len(ids) for ids, _ in outs)
        self.tokens_total += tokens
        self.batches_built += 1
        rb = RolloutBatch(
            version=self._version, batch=batch,
            prompts=self._n_prompts, completions=len(outs),
            tokens=tokens,
            mean_reward=round(float(batch["rewards"].mean()), 6))
        self._groups, self._reqs = [], []
        self._n_prompts, self._version = 0, None
        return rb


__all__ = ["ROLLOUT_TENANT", "RolloutBatch", "RolloutClient"]
