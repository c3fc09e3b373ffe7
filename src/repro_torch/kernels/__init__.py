"""Hand-written Hopper kernels of the port, their plain PyTorch versions and
the PyTorch oracles they are tested against."""


def launch_counts() -> dict:
    """Every kernel's launch count in this process, by name (each wrapper
    adds to its own where it launches its kernel; the plain versions
    count nothing)."""
    from repro_torch.kernels import cmerge, cscatter, decode_attention
    from repro_torch.kernels import flash_attention, selective_scan
    return {"cscatter": cscatter.cscatter.launches,
            "cmerge": cmerge.cmerge.launches,
            "flash_attention": flash_attention.flash_attention.launches,
            "decode_attention": decode_attention.decode_attention.launches,
            "selective_scan": selective_scan.selective_scan.launches}
