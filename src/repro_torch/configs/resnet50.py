"""resnet50 [conv] — the paper's own architecture (He et al. CVPR'16),
trained on ImageNet at 81,920 global batch with the paper's full recipe."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="resnet50",
    family="conv",
    source="paper TableI / arXiv:1512.03385",
    image_size=224,
    n_classes=1000,
    width=64,
    bn_momentum=0.9,     # paper §III-A.2 tunes this for 81,920 batch
    sync_bn=False,       # paper: per-process BN statistics
)
