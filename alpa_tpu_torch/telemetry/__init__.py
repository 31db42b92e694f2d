"""Performance accounting of the port (counterpart of ``alpa_tpu/telemetry``)."""
