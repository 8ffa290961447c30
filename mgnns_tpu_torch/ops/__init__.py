"""Ops namespace: re-exports the functional layers and the kernels, under the
names of the JAX package's ``mgnns_tpu.ops``.

The one name that differs is the kernel's: the JAX package exports its
Pallas entry point as ``window_max_aggregate_pallas`` beside the jnp
``window_max_aggregate``; here ``window_max_aggregate`` is
:func:`mgnns_tpu_torch.kernels.edge_max.window_max_aggregate`, which launches
K1 (and K2 under autograd) on CUDA tensors and runs the plain versions on
CPU tensors.  The port's core layers are named ``linear``, ``embedding`` and
``layer_norm``; they are exported as ``*_apply`` too.
"""

from mgnns_tpu_torch.kernels.edge_max import window_max_aggregate
from mgnns_tpu_torch.nn.attention import (
    add_positional_encoding,
    ffn_apply,
    ffn_init,
    head_diversity,
    label_attention_apply,
    label_attention_init,
    mha_apply,
    mha_init,
    my_another_mha_apply,
    my_another_mha_init,
    my_mha_apply,
    my_mha_init,
    positional_encoding_table,
)
from mgnns_tpu_torch.nn.coattention import (
    coattention_apply,
    coattention_init,
    masked_max,
    masked_mean,
    masked_softmax,
)
from mgnns_tpu_torch.nn.core import dropout, embedding_init, layer_norm_init, leaky_relu, linear_init
from mgnns_tpu_torch.nn.core import embedding as embedding_apply
from mgnns_tpu_torch.nn.core import layer_norm as layer_norm_apply
from mgnns_tpu_torch.nn.core import linear as linear_apply
from mgnns_tpu_torch.nn.image_gcn import graph_conv_apply, graph_conv_init
from mgnns_tpu_torch.nn.lstm import gru_apply, gru_init, lstm_apply, lstm_init
from mgnns_tpu_torch.nn.resnet import import_torch_state_dict, resnet_apply, resnet_init
from mgnns_tpu_torch.nn.text_gcn import text_gcn_apply, text_gcn_init, unique_word_readout

__all__ = [name for name in dir() if not name.startswith("_")]
