"""The benchmark's models, one module per architecture, found by name: a
configuration's ``"arch": "<name>"`` names ``archs/<name>.py``, which
``spec.arch`` loads as it loads a loop or a metric. A new architecture is a
new file here and configurations that name it; no shared file names one.

An architecture module provides:

- ``make_weights(cfg, seed, device) -> tree``: the weights the program is
  served, made on ``device`` from ``seed`` in the model's dtype;
- ``Reference(cfg, weights, weight_fn=None)``: the plain reference, with
  ``served_logits(prompt, served) -> [n, V]`` float32, the logits of the
  positions that produced the n served tokens (``weight_fn`` maps each
  2-D weight: the control's lower precision);
- ``model_flops(model, prompt_len, n_served)``: the FLOPs one request
  needs, padding left out (``mfu_pct``);
- ``attention_bound_s(cfg, requests)``: the least time of the decode
  attention of ``(prompt, served)`` pairs (``attn_roofline_pct``).

A module imports nothing of the program under test; it may import the
shared helpers of ``reference/model.py`` (``no_tf32``, ``round_to``,
``fp8_weights``, ``quantize_pages``) and ``roofline.py`` (the peaks and
``bound_s``).

Memory. The check runs once the window has closed, with only the
program's weight tree still on the card: the harness drops the engine and
empties the allocator's cache first. A module may draw its weights matrix
by matrix, may upcast one layer at a time inside ``served_logits``, and
may share the program's tree between the reference and its control, so
that a model whose served tree takes ~40% of the card can be drawn and
checked on it. A small model may keep a whole float32 copy, as ``gpt2``
does.
"""
