"""paddlebox_tpu_torch.obs — telemetry: log2-bucketed histograms behind
``STAT_OBSERVE`` (``obs/histogram.py``)."""
