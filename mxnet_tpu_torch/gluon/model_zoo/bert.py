"""BERT model family (counterpart of
``mxnet_tpu/gluon/model_zoo/bert.py``): ``BERTModel`` with its
pretraining heads (masked LM and next-sentence prediction), ``get_bert``,
``bert_base`` and ``bert_small``.

Parameter names are the JAX package's, so
:func:`mxnet_tpu_torch.gluon.convert.params_from_numpy` carries a JAX
BERT across by name.  Without ``valid_mask`` the encoder's attention runs
the flash kernels unmasked; with it, the masked flash kernels at every
layer (outside training, or at dropout 0).  ``use_flash=False`` runs
the plain attention math instead.  ``tp_mesh`` builds the encoder in
tensor-parallel mode and ``shard_tp`` places it Megatron-style over the
mesh's ``tp`` axis (:mod:`mxnet_tpu_torch.gluon.nn.transformer`):
embeddings, pooler and heads replicated.
"""
from __future__ import annotations

from ..block import HybridBlock
from ..nn.basic_layers import Dense, Dropout, Embedding, LayerNorm
from ..nn.transformer import TransformerEncoder

__all__ = ["BERTModel", "bert_base", "bert_small", "get_bert"]


class BERTModel(HybridBlock):
    """BERT encoder with pretraining heads.

    Inputs: ``(token_ids, token_types)`` each (batch, seq); optional
    ``valid_mask`` (batch, seq_q, seq_k).  Outputs ``(mlm_scores,
    nsp_scores)`` -- (batch, seq, vocab) and (batch, 2).
    """

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512,
                 type_vocab_size=2, dropout=0.1, use_flash=None,
                 tp_mesh=None, tp_axis="tp", dtype="float32", **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._tp_mesh = tp_mesh
        self._tp_axis = tp_axis
        with self.name_scope():
            self.word_embed = Embedding(vocab_size, units, dtype=dtype)
            self.token_type_embed = Embedding(type_vocab_size, units,
                                              dtype=dtype)
            self.encoder = TransformerEncoder(
                units, hidden_size, num_layers, num_heads,
                max_length=max_length, dropout=dropout, use_flash=use_flash,
                tp_mode=tp_mesh is not None, dtype=dtype)
            # pooler over [CLS] for next-sentence prediction
            self.pooler = Dense(units, activation="tanh", flatten=False,
                                in_units=units, dtype=dtype)
            self.nsp_classifier = Dense(2, flatten=False, in_units=units,
                                        dtype=dtype)
            # masked-LM decoder (transform + vocab projection)
            self.mlm_transform = Dense(units, activation="gelu",
                                       flatten=False, in_units=units,
                                       dtype=dtype)
            self.mlm_ln = LayerNorm(in_channels=units)
            self.mlm_decoder = Dense(vocab_size, flatten=False,
                                     in_units=units, dtype=dtype)
            self.embed_drop = Dropout(dropout)

    def shard_tp(self, mesh=None, axis=None):
        """Megatron-shard the encoder over the ``tp`` mesh axis
        (attention q/k/v column-parallel, out row-parallel, FFN
        column+row): two all-reduces per layer forward.  Embeddings,
        pooler and heads stay replicated (rank 0's values).  Call after
        ``initialize`` (deferred params take the placement when they
        are materialized)."""
        mesh = mesh if mesh is not None else self._tp_mesh
        axis = axis or self._tp_axis
        if mesh is None:
            raise ValueError("shard_tp needs a mesh (pass tp_mesh= at "
                             "construction or mesh= here)")
        from ...parallel.mesh import PartitionSpec as P
        from ...parallel.tensor_parallel import place_param
        self.encoder.shard_tp(mesh, axis)
        for block in (self.word_embed, self.token_type_embed, self.pooler,
                      self.nsp_classifier, self.mlm_transform, self.mlm_ln,
                      self.mlm_decoder):
            for prm in block.collect_params().values():
                place_param(prm, mesh, P())
        return self

    def hybrid_forward(self, F, token_ids, token_types=None, valid_mask=None):
        x = self.word_embed(token_ids)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        x = self.embed_drop(x)
        seq_out = self.encoder(x, valid_mask)
        cls = F.slice_axis(seq_out, axis=1, begin=0, end=1) \
            .reshape(token_ids.shape[0], self._units)
        nsp = self.nsp_classifier(self.pooler(cls))
        mlm = self.mlm_decoder(self.mlm_ln(self.mlm_transform(seq_out)))
        return mlm, nsp


_SPECS = {
    # name: (units, hidden, layers, heads)
    "bert_base": (768, 3072, 12, 12),
    "bert_large": (1024, 4096, 24, 16),
    "bert_small": (256, 1024, 4, 4),
}


def get_bert(name, vocab_size=30522, max_length=512, dropout=0.1,
             use_flash=None, tp_mesh=None, **kwargs):
    units, hidden, layers, heads = _SPECS[name]
    return BERTModel(vocab_size=vocab_size, units=units, hidden_size=hidden,
                     num_layers=layers, num_heads=heads,
                     max_length=max_length, dropout=dropout,
                     use_flash=use_flash, tp_mesh=tp_mesh, **kwargs)


def bert_base(**kwargs):
    """BERT-base: 12 layers, 768 units, 12 heads (Devlin et al. 2018)."""
    return get_bert("bert_base", **kwargs)


def bert_small(**kwargs):
    """Small BERT for tests."""
    return get_bert("bert_small", **kwargs)
