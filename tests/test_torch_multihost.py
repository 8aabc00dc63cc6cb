"""Two-process training and evaluation of the port on the CPU (the
counterpart of tests/test_multihost.py).

Launches `cli.train --device cpu --num_processes 2` twice, one process a
rank, joined over gloo through a file:// rendezvous in the test's
temporary directory (no TCP port), with the JAX test's configuration
(tests/multihost_driver.py) at one device a rank, so
`train.num_data_parallel=2`, and a validation batch of 2 so that both ranks
evaluate. Checks:

- both processes finish training and the validation gather;
- both print the identical mAP (prediction rows and loss sums gathered);
- exactly one best-model checkpoint, written by rank 0 alone, and
  TensorBoard events from rank 0 only (logs_p0, no logs_p1).
"""

import os
import re
import subprocess
import sys

import pytest

from yolov3_tensorflow_tpu_torch.data.synthetic import generate_dataset
from yolov3_tensorflow_tpu_torch.testing import CPU_TEST_THREADS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_train_and_eval(tmp_path):
    data = generate_dataset(str(tmp_path / "data"), num_images=8, seed=3,
                            img_size=(96, 96), max_shapes=2)
    out_dir = tmp_path / "run"
    out_dir.mkdir()
    rendezvous = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, OMP_NUM_THREADS=str(CPU_TEST_THREADS))

    def argv(pid):
        return [
            sys.executable, "-m", "yolov3_tensorflow_tpu_torch.cli.train",
            "--device", "cpu", "--coordinator_address", rendezvous,
            "--num_processes", "2", "--process_id", str(pid),
            f"data.train_file={data['annotation_file']}",
            f"data.val_file={data['annotation_file']}",
            f"data.class_name_path={data['names_file']}",
            "data.img_size=96,96", "data.multi_scale_train=false",
            "data.use_mix_up=false", "data.num_threads=2",
            "train.batch_size=4", "train.total_epochs=1",
            "train.train_evaluation_step=0", "train.val_evaluation_epoch=1",
            "train.save_epoch=0", "train.use_warm_up=false",
            "train.warm_up_epoch=0", "train.lr_type=fixed",
            "train.update_part=None", "train.restore_exclude=None",
            "train.num_data_parallel=2", "eval.batch_size=2",
            f"train.save_dir={out_dir / 'ckpt'}",
            f"train.log_dir={out_dir / f'logs_p{pid}'}",
            "train.progress_log_path="]

    procs = [subprocess.Popen(argv(pid), cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-4000:]}"

    maps = []
    for out in outs:
        m = re.search(r"mAP: ([0-9.]+)", out)
        assert m, f"no mAP line in output:\n{out[-4000:]}"
        maps.append(float(m.group(1)))
    assert maps[0] == pytest.approx(maps[1], abs=1e-9)

    ckpts = os.listdir(out_dir / "ckpt")
    assert len(ckpts) == 1 and ckpts[0].startswith("best_model_"), ckpts
    assert os.path.isdir(out_dir / "logs_p0")
    assert not os.path.isdir(out_dir / "logs_p1"), \
        "a non-primary process wrote TensorBoard events"
