from paddlebox_tpu_torch.metrics.auc import AucState, auc_compute, auc_init, auc_update

__all__ = ["AucState", "auc_init", "auc_update", "auc_compute"]
