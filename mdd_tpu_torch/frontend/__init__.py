"""Audio in, Kaldi-compatible features out: wav, fbank (with dither),
MFCC, spectrogram, CMVN, splice, the feature pipeline, Kaldi ark/scp IO
and training-time augmentation."""
