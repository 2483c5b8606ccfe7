"""resnet50 [cnn] — the paper's OWN workload domain (CNN inferencing).

Bottleneck ResNet-50 (stages 3-4-6-3), 224x224x3 inputs, 1000 classes.
Used by the paper-reproduction benchmarks (power/perf prediction of CNN
inference) and by the conv2d kernel (K2, ``kernels/conv2d.py``).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="resnet50",
    family="cnn",
    num_layers=16,              # bottleneck blocks
    d_model=2048,               # final feature width
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=1000,            # classes
    attn_type="none",
    use_rope=False,
    cnn_stages=(3, 4, 6, 3),
    cnn_width=64,
    image_size=224,
    remat="none",
)
