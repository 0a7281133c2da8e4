"""Audio in, Kaldi-compatible features out: wav, fbank (with dither),
MFCC, spectrogram, CMVN, splice, the feature pipeline, Kaldi ark/scp IO
and training-time augmentation."""

from mdd_tpu_torch.frontend.fbank import FbankConfig, compute_fbank, compute_fbank_batch
from mdd_tpu_torch.frontend.cmvn import CmvnStats, apply_cmvn, parse_kaldi_cmvn_text, write_kaldi_cmvn_text
from mdd_tpu_torch.frontend.splice import make_context, skip_frames, pad_to_multiple
from mdd_tpu_torch.frontend.augment import spec_augment, mutate_transcript
