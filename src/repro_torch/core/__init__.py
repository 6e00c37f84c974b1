"""Core of the paper, ported: redundant data assignment, recovery vectors,
the straggler-resilient k-median of Algorithm 1, the coresets, subspace
clustering and PCA of Algorithms 2 and 3, and the elastic resilience
runtime (sessions, on-device recovery, health-aware placement)."""

from .assignment import (  # noqa: F401
    Assignment,
    bernoulli_assignment,
    cyclic_assignment,
    fractional_repetition_assignment,
    make_assignment,
    min_cover_after_stragglers,
    node_loads,
    satisfies_property1,
    shard_replication,
    singleton_assignment,
    theorem6_ell,
)
from .placement import (  # noqa: F401
    PlacementOptimizer,
    choose_ell,
    expected_completion_time,
    health_assignment,
    round_miss_probability,
)
from .recovery import (  # noqa: F401
    RecoveryResult,
    device_recovery,
    device_recovery_masked,
    expand_to_all_nodes,
    lp_recovery,
    nnls_recovery,
    solve_recovery,
    uniform_recovery,
)
from .stragglers import (  # noqa: F401
    AdversarialScenario,
    DeadlineScenario,
    DeadlineStragglerSimulator,
    FixedCountScenario,
    IIDScenario,
    ScenarioStep,
    StragglerScenario,
    TraceScenario,
    adversarial_stragglers,
    fixed_count_stragglers,
    make_scenario,
    random_stragglers,
    record_trace,
)
from .resilience import ElasticPolicy, ResilienceSession, SessionStats  # noqa: F401
from .aggregation import mom_combine, resilient_sum, weighted_union  # noqa: F401
from .executor import Executor, LocalExecutor, get_executor, takes_weights  # noqa: F401
from .kmeans import (  # noqa: F401
    ClusteringResult,
    clustering_cost,
    lloyd,
    plusplus_init,
    resilient_cost,
)
from .kmedian import (  # noqa: F401
    ResilientClusteringOutput,
    ignore_stragglers_kmedian,
    local_cluster_batch,
    pack_local_shards,
    prepare_resilient_run,
    resilient_kmedian,
)
from .coreset import (  # noqa: F401
    Coreset,
    merge_coresets,
    resilient_coreset,
    sensitivity_coreset,
    uniform_coreset,
)
from .subspace import (  # noqa: F401
    ResilientSubspaceOutput,
    lloyd_subspace,
    resilient_subspace_clustering,
    subspace_cost,
)
from .pca import (  # noqa: F401
    ResilientPCAOutput,
    centralized_pca,
    pca_cost,
    relaxed_coreset_rank,
    resilient_pca,
)
