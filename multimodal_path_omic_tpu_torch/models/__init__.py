from multimodal_path_omic_tpu_torch.models.ge_nacagat import GENaCAGaT
from multimodal_path_omic_tpu_torch.models.mcat import MCAT
from multimodal_path_omic_tpu_torch.models.nacagat import NaCAGaT

# the config's ``model.name`` values of the WSI-only model, normalized
GE_NAMES = ("ge_nacagat", "genacagat", "geneexpr_nacagat", "geneexprnacagat")


def _key(name: str) -> str:
    return name.lower().replace("-", "_").replace(" ", "")


def is_ge_model(name: str) -> bool:
    return _key(name) in GE_NAMES


def build_model(name: str, *, omic_sizes=None, model_size: str = "medium",
                fusion: str = "concat", n_classes=None, dropout: float = 0.25,
                wsi_dim: int = 1024, lean: bool = True):
    """Model factory keyed by the config's ``model.name`` values: MCAT and
    NaCAGaT (survival, 4 classes) and GE-NaCAGaT (WSI-only, 3 classes; takes
    no ``omic_sizes``). ``lean=False`` switches the survival models'
    co-attention off its lean routes (``ops/attention.py``); GE-NaCAGaT has
    no such route."""
    key = _key(name)
    if key in ("mcat", "multimodalcoattentiontransformer"):
        return MCAT(omic_sizes, model_size=model_size, n_classes=n_classes or 4,
                    dropout_rate=dropout, fusion=fusion, wsi_dim=wsi_dim, lean=lean)
    if key in ("nacagat", "narrowcontextualattentiongatetransformer"):
        return NaCAGaT(omic_sizes, model_size=model_size, n_classes=n_classes or 4,
                       dropout_rate=dropout, fusion=fusion, wsi_dim=wsi_dim, lean=lean)
    if key in GE_NAMES:
        return GENaCAGaT(model_size=model_size, n_classes=n_classes or 3,
                         dropout_rate=dropout, wsi_dim=wsi_dim)
    raise ValueError(f"Unknown model name: {name}")


__all__ = ["GENaCAGaT", "MCAT", "NaCAGaT", "build_model", "is_ge_model"]
