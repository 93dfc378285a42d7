from multimodal_path_omic_tpu_torch.models.ge_nacagat import GENaCAGaT
from multimodal_path_omic_tpu_torch.ops.layers import set_compute_dtype
from multimodal_path_omic_tpu_torch.models.mcat import MCAT
from multimodal_path_omic_tpu_torch.models.nacagat import NaCAGaT

# the config's ``model.name`` values of the WSI-only model, normalized
GE_NAMES = ("ge_nacagat", "genacagat", "geneexpr_nacagat", "geneexprnacagat")
NACAGAT_NAMES = ("nacagat", "narrowcontextualattentiongatetransformer")


def _key(name: str) -> str:
    return name.lower().replace("-", "_").replace(" ", "")


def is_ge_model(name: str) -> bool:
    return _key(name) in GE_NAMES


def build_model(name: str, *, omic_sizes=None, model_size: str = "medium",
                fusion: str = "concat", n_classes=None, dropout: float = 0.25,
                wsi_dim: int = 1024, lean: bool = True, bug_compat: bool = False,
                dtype=None, mesh=None):
    """Model factory keyed by the config's ``model.name`` values: MCAT and
    NaCAGaT (survival, 4 classes) and GE-NaCAGaT (WSI-only, 3 classes; takes
    no ``omic_sizes``). ``lean=False`` switches the survival models'
    co-attention off its lean routes (``ops/attention.py``); GE-NaCAGaT has
    no such route. ``bug_compat`` freezes the ``gated_concat`` fusion's gates
    at their init (the reference's unregistered gates). ``dtype`` (None or
    ``torch.float32``: float32; ``torch.bfloat16``) is the compute dtype of
    every module (``ops/layers.py::set_compute_dtype``); the parameters stay
    float32 and the survival and class heads compute in float32. ``mesh``
    (a ``parallel.mesh.Mesh``; JAX ``ring_mesh``) reaches the modules that
    run over the patch axis (``carry_mesh`` of each model)."""
    model = set_compute_dtype(_build(name, omic_sizes, model_size, fusion, n_classes,
                                     dropout, wsi_dim, lean, bug_compat), dtype)
    if mesh is not None:
        model.carry_mesh(mesh)
    return model


def _build(name, omic_sizes, model_size, fusion, n_classes, dropout, wsi_dim, lean,
           bug_compat):
    key = _key(name)
    if key in ("mcat", "multimodalcoattentiontransformer"):
        return MCAT(omic_sizes, model_size=model_size, n_classes=n_classes or 4,
                    dropout_rate=dropout, fusion=fusion, wsi_dim=wsi_dim, lean=lean,
                    bug_compat=bug_compat)
    if key in NACAGAT_NAMES:
        return NaCAGaT(omic_sizes, model_size=model_size, n_classes=n_classes or 4,
                       dropout_rate=dropout, fusion=fusion, wsi_dim=wsi_dim, lean=lean,
                    bug_compat=bug_compat)
    if key in GE_NAMES:
        return GENaCAGaT(model_size=model_size, n_classes=n_classes or 3,
                         dropout_rate=dropout, wsi_dim=wsi_dim)
    raise ValueError(f"Unknown model name: {name}")


__all__ = ["GENaCAGaT", "MCAT", "NaCAGaT", "build_model", "is_ge_model"]
