"""LDR discrepancy scores of the port (numpy only)."""
from diagan_tpu_torch.score.score import (
    calculate_scores,
    prepare_sample_weights,
    warn_if_degenerate_weights,
)

__all__ = ["calculate_scores", "prepare_sample_weights", "warn_if_degenerate_weights"]
