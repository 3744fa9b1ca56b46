from gigalens_tpu_torch.ops.psf import PSFConv, average_pool, subgrid_kernel

__all__ = ["PSFConv", "average_pool", "subgrid_kernel"]
