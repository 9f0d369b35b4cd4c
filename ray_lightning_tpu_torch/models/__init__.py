"""Model families (twin of `ray_lightning_tpu/models/`). Names resolve on
first use."""
from ray_lightning_tpu_torch._lazy import lazy_exports

_NAMES = {
    **{n: "bert" for n in (
        "BertClassifierModule", "BertConfig", "BertEncoder",
        "BertForSequenceClassification")},
    "bert_classifier_params_from_hf": "hf_interop",
    "bert_params_from_hf": "hf_interop",
    "Llama": "llama",
    "LlamaConfig": "llama",
    "LlamaModule": "llama",
    "generate": "llama",
    "init_cache": "llama",
    "llama_params_from_hf": "hf_interop",
    "MLP": "mlp",
    "MLPClassifier": "mlp",
    "MNISTClassifier": "mlp",
    **{n: "moe" for n in (
        "MoEClassifierModule", "MoEMLP", "moe_param_specs")},
    **{n: "resnet" for n in (
        "ResNet", "ResNetModule", "resnet18", "resnet34", "resnet50")},
}
_MISSING: dict = {}

__all__ = list(_NAMES)

__getattr__, __dir__ = lazy_exports(__name__, _NAMES, _MISSING)
