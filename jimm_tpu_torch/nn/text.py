"""Text tower: token + positional embedding, encoder, final LN, pooling;
the counterpart of ``jimm_tpu/nn/text.py``. The positional table is sliced
to the input length; SigLIP pools the last position, CLIP the EOT token.
Under a rule that shards the sequence, the encoder runs on this rank's
chunk of the tokens, gathered before the final LayerNorm (as in
`nn/vision.py`)."""

from __future__ import annotations

import torch
from torch import nn

from jimm_tpu_torch.configs import TextConfig
from jimm_tpu_torch.nn.transformer import (Transformer, _layernorm,
                                           sequence_parallel)
from jimm_tpu_torch.parallel.sharding import (gather_sequence,
                                              logical_constraint,
                                              sequence_sharded,
                                              vocab_embedding)


class TextTower(nn.Module):
    def __init__(self, cfg: TextConfig, *, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.width, **kw)
        self.pos_embed = nn.Parameter(
            torch.zeros(cfg.context_length, cfg.width, **kw))
        self.encoder = Transformer(cfg.encoder(), **kw)
        self.ln_final = _layernorm(cfg.width, cfg.ln_eps, **kw)

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        """(B, S) int token ids -> (B, S, width) final hidden states."""
        # on a model axis: this rank's slice of the vocabulary, summed
        x = vocab_embedding(self.token_embed, text)
        # under a rule that shards the sequence: this rank's chunk
        seq = sequence_parallel(self.cfg, text.shape[1])
        x = (logical_constraint(x, "batch", "seq", None)
             + logical_constraint(self.pos_embed[:text.shape[1]], "seq",
                                  None).to(x.dtype))
        with sequence_sharded(seq):
            x = self.encoder(x)
        return self.ln_final(gather_sequence(x, seq))

    def pool(self, hidden: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        """Pool final hidden states per the configured strategy."""
        if self.cfg.pooling == "eot":
            if self.cfg.eos_token_id in (None, 2):
                # legacy HF CLIP: EOT is the largest id in the vocabulary
                eot = text.argmax(dim=-1)
            else:
                # first occurrence of the EOS id (0 when a row has none)
                eot = (text == self.cfg.eos_token_id).int().argmax(dim=-1)
            return hidden[torch.arange(hidden.shape[0], device=hidden.device),
                          eot]
        if self.cfg.pooling == "last":
            return hidden[:, -1]
        raise ValueError(f"unsupported text pooling {self.cfg.pooling!r}")
