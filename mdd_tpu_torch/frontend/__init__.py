"""Audio in, Kaldi-compatible features out: wav, fbank, CMVN, splice,
Kaldi ark/scp IO and training-time augmentation."""
