"""mdd_tpu_torch — the PyTorch + CUDA port of mdd_tpu.

The serving path of mdd_tpu (fbank front end, CMVN, splice, the
CNN + 4 x BiLSTM + canonical-text-attention CTC model, greedy decoding,
alignment and MDD scoring, the line-delimited JSON server on stdin or a
socket, the denoiser and the feature command) and its training path
(ark/scp corpus, augmentation, bucketed loader, CTC loss, Adam and the
plateau machine, resumable checkpoints; one rank a process over
torch.distributed with `--distributed`) in PyTorch, with the acoustic
BiLSTM recurrence and dropout in hand-written Hopper kernels
(csrc/lstm_fwd.cu, csrc/lstm_bwd.cu, csrc/dropout.cu) and the host C++
of csrc/*.cc built with g++.  Module names mirror mdd_tpu's, so
each module's counterpart is easy to find.  Entry points run on the GPU
("cuda") unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
