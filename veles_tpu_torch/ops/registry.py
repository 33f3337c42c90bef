"""Layer-config type name -> forward unit class and gradient unit class.

Counterpart of ``veles_tpu/ops/registry.py``: the same 24 layer type
names, each with its forward unit and its gradient unit.
"""

from __future__ import annotations

from typing import Dict

from veles_tpu_torch.ops import (activation, all2all, conv, cutter, deconv,
                                 depooling, dropout, lrn, pooling, rbm,
                                 resizable_all2all)

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
    "deconv": deconv.Deconv,
    "depooling": depooling.Depooling,
    "stochastic_pooling": pooling.StochasticPooling,
    "activation_tanh": activation.ActivationTanh,
    "activation_relu": activation.ActivationRELU,
    "activation_sigmoid": activation.ActivationSigmoid,
    "activation_log": activation.ActivationLog,
    "activation_strict_relu": activation.ActivationStrictRELU,
    "all2all_sigmoid": all2all.All2AllSigmoid,
    "rbm": rbm.RBM,
    "binarization": rbm.Binarization,
    "cutter": cutter.Cutter,
    "resizable_all2all": resizable_all2all.ResizableAll2All,
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
    "deconv": deconv.GradientDescentDeconv,
    "depooling": depooling.GDDepooling,
    "stochastic_pooling": pooling.GDStochasticPooling,
    "activation_tanh": activation.GDActivation,
    "activation_relu": activation.GDActivation,
    "activation_sigmoid": activation.GDActivation,
    "activation_log": activation.GDActivation,
    "activation_strict_relu": activation.GDActivation,
    "all2all_sigmoid": all2all.GDSigmoid,
    "rbm": rbm.GDRBM,
    "binarization": rbm.GDBinarization,
    "cutter": cutter.GDCutter,
    "resizable_all2all": resizable_all2all.GDResizableAll2All,
}
