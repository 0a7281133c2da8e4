"""The tests' small sizes of a cell: a narrow model and a short corpus,
every other setting as the cell's files give it."""

CFG = {"rnn_hidden_size": 16, "channel": [[1, 4], [4, 4]]}
MIX = {"n_utts": 40, "batch_size": 8, "min_phones": 4, "max_phones": 10,
       "trace_steps": 4, "warmup_epochs": 1}
CELL = "attention_aug.train_b256"
# a local mesh's global batch at the small size (rank_entry.py)
DP_MIX = dict(MIX, batch_size=16)
