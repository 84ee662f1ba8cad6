"""Performance accounting: parameter counts, analytic FLOPs, the card's peak.

FLOPs per token are the reference's 6N + 12·layers·heads·head_dim·seq_len.
The MFU denominator is the dense bf16 tensor-core peak of the card in use,
chosen by its name; a card not in the table has no peak, and its MFU is
reported as None rather than against another card's figure.
"""

# Dense bf16 peak FLOP/s by card name (NVIDIA data sheets, SXM parts; the
# H100 figure is the reference's own constant, train.py:287).
GPU_PEAK_FLOPS_BF16 = {
    "H100": 989e12,
    "H200": 989e12,
}


# Device memory by card name (NVIDIA data sheets): what `utils/remat.py`
# sizes against when a device kind is named instead of read from the card.
GPU_MEMORY_BYTES = {
    "H100": 80 * 10**9,
    "H200": 141 * 10**9,
}


def gpu_memory_bytes(device_name):
    """Device memory for a card name, or None when the card is unknown."""
    for key, cap in GPU_MEMORY_BYTES.items():
        if key in str(device_name):
            return cap
    return None


def gpu_peak_flops(device_name):
    """Peak bf16 FLOP/s for a card name, or None when the card is unknown."""
    for key, peak in GPU_PEAK_FLOPS_BF16.items():
        if key in str(device_name):
            return peak
    return None


_warned_unknown = set()


def peak_flops_or_warn(device_name):
    """`gpu_peak_flops`, and for a device not in the table (the CPU too) one
    warning and one ``mfu_peak_unknown`` event per name per process, as the
    JAX package warns of an unknown TPU kind. MFU is then None: the port
    uses no stand-in peak."""
    peak = gpu_peak_flops(device_name)
    if peak is None and device_name not in _warned_unknown:
        _warned_unknown.add(device_name)
        from pyrecover_tpu_torch import telemetry
        from pyrecover_tpu_torch.utils.logging import log_host0

        log_host0("device %r has no peak-FLOP/s entry; MFU is not reported", device_name,
                  level=30)  # WARNING
        telemetry.emit("mfu_peak_unknown", device_kind=device_name, fallback_flops=None)
    return peak


def get_num_params(model, exclude_embedding=False):
    """Total parameter count; ``exclude_embedding`` drops parameters whose
    name contains ``embed`` (the FLOPs-accounting convention)."""
    return sum(
        p.numel() for name, p in model.named_parameters()
        if not (exclude_embedding and "embed" in name.lower())
    )


def get_num_flop_per_token(num_params, n_layers, n_heads, head_dim, seq_len):
    """Analytic FLOPs/token: 6N + 12·l·h·q·t (reference `utils.py:41-56`)."""
    return 6 * num_params + 12 * n_layers * n_heads * head_dim * seq_len
