from u2pl_tpu_torch.models.builder import SegModel, build_model

__all__ = ["SegModel", "build_model"]
