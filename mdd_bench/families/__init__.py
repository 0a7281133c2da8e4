"""Model families: everything of the yardstick that depends on a model's
architecture, one file a family, found by name.

A configuration file names its family under `"family"` (no default);
`manifest.family(cfg)` loads `families/<family>.py` by its path, as
`trace.load_reader` loads a metric, and raises `SystemExit` naming the
families there are when the file is missing.  The reference
(`reference.run_steps`), the weights (`weights.make_weights`) and the FLOP
count (`flops.train_step_flops`) call the family and know no parameter,
layer or size of a model.

A family file defines, in plain PyTorch (it imports nothing of the
program, and `cfg` is its configuration file as a dict):

* `param_shapes(cfg) -> {name: shape}`: every parameter, under the name
  the program's `model.named_parameters()` gives it, in the order the
  weights are drawn;
* `spread(name, shape, cfg) -> (half_width, constant)`: the leaf's
  initializer, as `weights.make_weights` applies it to a uniform draw in
  [-1, 1): `draw * half_width + constant` (a constant leaf has half-width
  0);
* `forward(P, cfg, x, trans, trsizes, valid, gens, q) -> log_probs`: the
  model in train mode, (B, T, D) spliced float32 features -> (T', B, C)
  float32 log-probs, with `trans` (B, L) the canonical transcripts and
  `trsizes` their lengths, `valid` (B,) the real rows (BatchNorm's
  statistics are theirs: `reference.batch_norm`), `gens` the ranks'
  dropout generators (`reference.dropout`), and every product's operands
  passed through `q` (the fp8 control's rounding; the identity in
  float32);
* `ctc_sizes(cfg, frames, t_in, t_out) -> sizes`: the CTC input length
  of each row, from its spliced model frames (a (B,) tensor), the
  forward's input length T and its output length T';
* `row_flops(cfg, frames, label_len) -> float`: the analytic FLOPs of one
  row's forward at `frames` spliced frames and `label_len` transcript
  phones (`flops.train_step_flops` takes three times it for a train
  step).

A configuration of a new family is added with new files only:
`families/<family>.py`, `configs/<name>.json`, a mix, a limits file,
readers for its kernels' rooflines (their work functions in the family
file or the metric files) and its entries in BENCHMARK.json.
"""
