from repro_torch.data.pipeline import (SyntheticLM, TensorSpec, batch_lines,
                                       make_batch_specs)

__all__ = ["SyntheticLM", "TensorSpec", "batch_lines", "make_batch_specs"]
