from gigalens_tpu_torch.parallel.mesh import (
    Mesh,
    at_global_rows,
    all_max,
    all_min,
    all_sum,
    default_mesh,
    gather_samples,
    replicate,
    round_to_multiple,
    sample_max,
    sample_mean,
    sample_min,
    sample_sum,
    shard_samples,
    spawn_ranks,
)

__all__ = ["Mesh", "default_mesh", "shard_samples", "gather_samples", "replicate",
           "all_sum", "all_max", "all_min", "sample_sum", "sample_mean", "sample_max",
           "sample_min", "round_to_multiple", "at_global_rows", "spawn_ranks"]
