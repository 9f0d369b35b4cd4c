"""Model families (twin of `ray_lightning_tpu/models/`). Names resolve on
first use."""
from ray_lightning_tpu_torch._lazy import lazy_exports

_NAMES = {
    "Llama": "llama",
    "LlamaConfig": "llama",
    "LlamaModule": "llama",
    "MLP": "mlp",
    "MLPClassifier": "mlp",
    "MNISTClassifier": "mlp",
}
_ITEM_13 = "ROADMAP Queue 1 item 13 (the remaining models)"
_MISSING = {
    **{n: _ITEM_13 for n in (
        "BertClassifierModule", "BertConfig", "BertEncoder",
        "BertForSequenceClassification", "bert_classifier_params_from_hf",
        "bert_params_from_hf", "MoEClassifierModule", "MoEMLP",
        "moe_param_specs", "ResNet", "ResNetModule", "resnet18",
        "resnet34", "resnet50")},
    "generate": "ROADMAP Queue 1 item 8 (generate)",
    "init_cache": "ROADMAP Queue 1 item 8 (generate)",
    "llama_params_from_hf": "ROADMAP Queue 1 item 3 (models/hf_interop.py)",
}

__all__ = list(_NAMES)

__getattr__, __dir__ = lazy_exports(__name__, _NAMES, _MISSING)
