"""The engine-driven replays of the port: a seeded, bit-for-bit
reproducible day of requests through the port's engines on a shared
:class:`~kubedl_tpu_torch.core.clock.SimClock`, read back from the
system's own spans and metric registries (the counterparts of the JAX
package's ``kubedl_tpu/replay`` modules that drive an engine):

* :class:`ServingReplay` — one continuous-batching engine through a
  Zipf-prefix request day (``replay/serving.py``);
* :class:`ServingFleetReplay` — replicas, the prefix-aware router and
  the autoscaler through a tenant-labelled day (``replay/fleet.py``);
* :class:`FlywheelReplay` — the fleet day with one RLJob riding it: the
  rollout tenant, the GRPO learner with its elastic resize, and weight
  publishes rolled across the replicas (``replay/rl.py``);
* :class:`~kubedl_tpu_torch.replay.multimodel.MultiModelReplay` — the
  fleet day with a Zipf adapter catalog, adapter-aware against
  adapter-blind routing (``replay/multimodel.py``).

Each runs on the card unless the caller passes ``device="cpu"``. Beside
them, :class:`ClusterReplay` drives a job day through the real control
plane (the journaled, replicated API server, the manager, the slice
scheduler and the engine, under chaos) and no serving engine
(``replay/harness.py``, a copy); the federation day runs one per region
(:mod:`kubedl_tpu_torch.federation`). The scorecards that gate those days
(``replay/scorecard.py``) and the elastic comparison, spot shrink against
whole-gang restarts through the job day (``replay/elastic.py``), are
copies too.
"""

from .workload import PROFILES, Profile, Workload, generate  # noqa: F401
from .harness import ClusterReplay  # noqa: F401
from .serving import ServingReplay, default_serving_slos  # noqa: F401
from .scorecard import (build_scorecard, check_regression,  # noqa: F401
                        evaluate_gates)
from .scorecard import (build_campaign_scorecard,  # noqa: F401
                        check_campaign_regression,
                        evaluate_campaign_gates)
from .elastic import (build_elastic_block,  # noqa: F401
                      run_elastic_comparison)
from .fleet import (FLEET_PROFILES, FleetProfile,  # noqa: F401
                    FleetWorkload, ServingFleetReplay, generate_fleet,
                    run_autoscaler_leg, run_disagg_comparison,
                    run_fleet_comparison, run_routing_comparison)
from .rl import (FlywheelReplay, RLJobSpec,  # noqa: F401
                 run_flywheel_leg)
