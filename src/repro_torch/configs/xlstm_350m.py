"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks, 7:1 mLSTM:sLSTM ratio per the xLSTM LM recipe. d_ff=0: the blocks
carry their own up/down projections (mLSTM pf=2, sLSTM conv+gates).
[arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=tuple([BlockDef(attn="mlstm", ffn="none")] * 7
                  + [BlockDef(attn="slstm", ffn="none")]),
    norm="rmsnorm",
    act="silu",
    ffn_gated=False,
    pos="none",
    tie_embeddings=True,
    source="[arXiv:2405.04517; unverified]",
)
