"""The paper's contribution: attention-head-level partitioning + myopic
resource-aware migration for low-latency edge LLM inference."""
from repro_torch.core.algorithm import (  # noqa: F401
    AlgoStats,
    ResourceAwareAssigner,
    refine_bottleneck,
    stage_balanced_chain,
)
from repro_torch.core.baselines import (  # noqa: F401
    ALL_POLICIES,
    BottleneckAwarePolicy,
    ColumnCoPartitionPolicy,
    DynamicLayerPolicy,
    EdgeShardPolicy,
    GalaxyPolicy,
    GreedyPolicy,
    Policy,
    ResourceAwarePolicy,
    RoundRobinPolicy,
    StaticPolicy,
)
from repro_torch.core.blocks import (  # noqa: F401
    Block,
    BlockGraph,
    CostModel,
    FFN,
    HEAD,
    PROJ,
    blocks_per_layer,
    graph_of,
    make_blocks,
    replicate_placement,
    stage_partition,
)
from repro_torch.core.delay import (  # noqa: F401
    bottleneck_attribution,
    inference_delay,
    memory_feasible,
    memory_usage,
    migration_delay,
    pipeline_bottleneck,
    pipelined_inference_delay,
    pipelined_total_delay,
    resource_busy_times,
    total_delay,
)
from repro_torch.core.network import DeviceNetwork, GB, GBPS, GFLOPS  # noqa: F401
from repro_torch.core.scoring import comm_factor, score, score_matrix  # noqa: F401
from repro_torch.core.simulator import SimResult, compare_policies, simulate  # noqa: F401
from repro_torch.core.solver import exact_horizon, exact_myopic  # noqa: F401
