"""Utilities of the port (counterpart of ``alpa_tpu/util.py``, in part)."""


def compute_gpt_tflops(batch_size,
                       seq_len,
                       num_layers,
                       hidden_size,
                       vocab_size,
                       num_devices,
                       latency,
                       backward=True,
                       checkpoint_activations=False):
    """Analytic GPT TFLOPS per device, the formula of
    ``alpa_tpu.util.compute_gpt_tflops``."""
    factor = 24
    if backward:
        factor += 48
        if checkpoint_activations:
            factor += 24
    total_flop = (factor * batch_size * seq_len * (hidden_size**2) * num_layers *
                  (1 + seq_len / (6 * hidden_size)) +
                  (6 if backward else 2) * batch_size * seq_len * hidden_size * vocab_size)
    tflops = total_flop / latency / num_devices / 1e12
    return tflops
