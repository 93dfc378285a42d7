from multimodal_path_omic_tpu_torch.models.nacagat import NaCAGaT


def build_model(name: str, *, omic_sizes, model_size: str = "medium",
                fusion: str = "concat", n_classes=None, dropout: float = 0.25,
                wsi_dim: int = 1024):
    """Model factory keyed by the config's ``model.name`` values. Only
    NaCAGaT is ported so far."""
    key = name.lower().replace("-", "_").replace(" ", "")
    if key in ("nacagat", "narrowcontextualattentiongatetransformer"):
        return NaCAGaT(omic_sizes, model_size=model_size, n_classes=n_classes or 4,
                       dropout_rate=dropout, fusion=fusion, wsi_dim=wsi_dim)
    raise NotImplementedError(f"model {name!r} is not ported yet")


__all__ = ["NaCAGaT", "build_model"]
