"""End-to-end training example on the PyTorch port (twin of
examples/train_lm.py, which runs the JAX reference): train a small
qwen-family model for a few hundred steps with checkpoint/restart and
straggler telemetry — the data pipeline, AdamW and the checkpoint
catalog on a Honeycomb store.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]
"""
import argparse
import dataclasses
import shutil
import tempfile
from pathlib import Path

from repro_torch.configs import get_smoke_config
from repro_torch.train.train_loop import LoopConfig, build_smoke_loop

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda",
                help="cuda (default) or cpu (the plain PyTorch path)")
args = ap.parse_args()

CKPT = Path(tempfile.gettempdir()) / "repro_torch_example_ckpt"
shutil.rmtree(CKPT, ignore_errors=True)

cfg = dataclasses.replace(get_smoke_config("qwen2p5_3b"),
                          n_layers=4, d_model=128, d_ff=256, vocab=512)
loop = build_smoke_loop(cfg, batch=16, seq=64, ckpt_dir=CKPT,
                        loop_cfg=LoopConfig(total_steps=200, ckpt_every=100,
                                            log_every=20),
                        device=args.device)
summary = loop.run()
print("metrics:")
for m in loop.metrics_log:
    print(f"  step {m['step']:4d}  loss {m['loss']:.4f}  "
          f"gnorm {m['gnorm']:.3f}  {m['step_time_s']*1e3:.0f} ms")
print("summary:", summary)
first, last = loop.metrics_log[0]["loss"], loop.metrics_log[-1]["loss"]
print(f"loss {first:.3f} -> {last:.3f} "
      f"({'LEARNING' if last < first - 0.5 else 'check lr'})")

# restart drill: restore from the Honeycomb-cataloged checkpoint
print("\ncheckpoint catalog steps:", loop.ckpt.all_steps())
print("restore floor lookup latest<=150:", loop.ckpt.latest_step(150))
loop.pipeline.close()
