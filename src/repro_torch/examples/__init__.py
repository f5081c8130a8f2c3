"""The port's counterparts of the reference's ``examples/``, each run as
``python -m repro_torch.examples.<name>`` — on the CUDA card unless
``--device cpu`` is given:

* :mod:`.quickstart` — the compiler driver on a gather-then-compute
  kernel: report, every backend, a stream, the Fig. 2/5 simulation;
* :mod:`.spmv_dataflow` — the main path: SpMV's CSR loop compiled in
  loop mode, simulated on the Zynq ACP model, then the BSR product on
  the hand-written ``spmv_bsr`` kernel;
* :mod:`.serve_decode` — batched prefill and decode of reduced
  Qwen2.5, with the bf16 and the int8 KV cache;
* :mod:`.train_lm` — reduced SmolLM trained by ``train_loop`` with
  checkpoints under ``build/``; the loss must fall.
"""
