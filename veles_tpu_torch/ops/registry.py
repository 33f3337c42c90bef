"""Layer-config type name -> forward unit class and gradient unit class.

Counterpart of ``veles_tpu/ops/registry.py`` for the layer types of the
AlexNet family.
"""

from __future__ import annotations

from typing import Dict

from veles_tpu_torch.ops import all2all, conv, dropout, lrn, pooling

forward_registry: Dict[str, type] = {
    "conv": conv.Conv,
    "conv_tanh": conv.ConvTanh,
    "conv_relu": conv.ConvRELU,
    "norm": lrn.LRNormalizer,
    "max_pooling": pooling.MaxPooling,
    "avg_pooling": pooling.AvgPooling,
    "all2all": all2all.All2All,
    "all2all_tanh": all2all.All2AllTanh,
    "all2all_relu": all2all.All2AllRELU,
    "softmax": all2all.All2AllSoftmax,
    "dropout": dropout.Dropout,
}

gd_registry: Dict[str, type] = {
    "conv": conv.GradientDescentConv,
    "conv_tanh": conv.GDConvTanh,
    "conv_relu": conv.GDConvRELU,
    "norm": lrn.GDLRNormalizer,
    "max_pooling": pooling.GDMaxPooling,
    "avg_pooling": pooling.GDAvgPooling,
    "all2all": all2all.GradientDescent,
    "all2all_tanh": all2all.GDTanh,
    "all2all_relu": all2all.GDRELU,
    "softmax": all2all.GDSoftmax,
    "dropout": dropout.GDDropout,
}
