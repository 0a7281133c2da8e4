"""CTC decoding."""

from mdd_tpu_torch.decode.greedy import greedy_decode, collapse_ctc
from mdd_tpu_torch.decode.arpa import ArpaBigramLM
from mdd_tpu_torch.decode.beam import BeamSearchDecoder
