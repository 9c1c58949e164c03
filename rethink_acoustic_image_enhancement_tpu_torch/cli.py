"""Command-line entry points of the PyTorch/CUDA port.

  raie-torch train -opt cfg.yml  config-driven training (auto-resume from
                                 path.training_states: the port's
                                 ckpt_<iter>.pth or a JAX run's orbax
                                 ckpt_<iter>/; --launcher pytorch under
                                 torchrun or SLURM for data parallelism)
  raie-torch train-asdqe ...     ASDQE quality-scorer training
  raie-torch test -opt cfg.yml   config-driven offline evaluation
  raie-torch infer-teacher ...   KDLAE-T denoise (whole image, groups, tiles)
  raie-torch serve ...           watch-folder serving daemon
  raie-torch infer-student ...   KDLAE-S multi-frame denoise
  raie-torch score ...           ASDQE method-vs-origin protocol (CSV)
  raie-torch convert ...         reference .pth <-> orbax checkpoint
  raie-torch doctor              device diagnostics (bounded child probe)

(or ``python -m rethink_acoustic_image_enhancement_tpu_torch.cli``). Flags,
defaults and outputs are the JAX package's ``raie``; ``--device`` (``cuda``
by default, ``cpu`` to run on the CPU) takes the place of its
``JAX_PLATFORMS``, and without a GPU the default exits with an error rather
than fall back to the CPU. Serving is the JAX CLI's: float32 with TF32 off,
no stage kernel, no folded resamplers. ``--weights`` takes a reference-layout
``.pth``, an orbax checkpoint directory (read by ``convert/orbax.py``, no JAX
needed) or a zoo alias: its ``.pth`` in ``artifacts/torch_zoo/`` (written by
``scripts/export_torch_zoo.py``), else the orbax directory the JAX CLI's alias
names.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPORT_SCRIPT = "scripts/export_torch_zoo.py"

# Zoo aliases for --weights (the JAX CLI's, with its serving presets):
# (repo-relative .pth, the JAX CLI's orbax directory read where the .pth is
# absent, default denoise_rate or None)
_ZOO = {
    "teacher": ("artifacts/torch_zoo/teacher.pth",
                "artifacts/kdlaet_full50k/weights/net_g_50000_bf16", 1.0),
    # the L2-Dice teacher is served at denoise_rate 0.6 (KDLAE_T.ipynb cell 5)
    "teacher-l2dice": ("artifacts/torch_zoo/teacher-l2dice.pth",
                       "artifacts/kdlaet_l2dice50k/weights/net_g_50000_bf16", 0.6),
    "student-us": ("artifacts/torch_zoo/student-us.pth",
                   "artifacts/kdlaes_full100k/weights/net_g_100000", None),
    "student-fls": ("artifacts/torch_zoo/student-fls.pth",
                    "artifacts/kdlaes_flsft5k/weights/net_g_5000", None),
}
ARCHS = ["KDLAE_teacher", "RestormerSuperResolutionParam2", "Restormer",
         "KDLAE_student", "DenoiseRatePredictor"]  # convert --arch
_SCORER = "artifacts/torch_zoo/asdqe.pth"  # score's default --weights


def _device(name: str):
    from .eval.infer import resolve_device

    try:
        return resolve_device(None if name == "cuda" else name)
    except RuntimeError as exc:
        raise SystemExit(f"error: {exc} (--device cpu on the command line)") from None


def _init_ranks(args) -> None:
    """Join the process group before any device use (the reference's
    --launcher pytorch|slurm -> init_dist handshake, train.py:57-67): the
    flags win, else the launcher's env. A launcher asked for without its
    env exits; nothing falls back to one process."""
    from . import parallel

    if args.launcher == "none" and not (args.coordinator or args.num_processes):
        return
    backend = "gloo" if args.device == "cpu" else None
    if not parallel.init_distributed(args.coordinator, args.num_processes,
                                     args.process_id, backend=backend) \
            and args.num_processes != 1:
        raise SystemExit(
            f"error: --launcher {args.launcher}: no launcher env (torchrun's "
            "RANK and WORLD_SIZE, or SLURM's SLURM_PROCID and SLURM_NTASKS "
            "with MASTER_ADDR or a single-host SLURM_STEP_NODELIST) and no "
            "--coordinator/--num-processes/--process-id")


def _cmd_train(args) -> int:
    from . import parallel
    from .train.config import parse
    from .train.loop import train_from_config

    _init_ranks(args)
    try:
        device = _device(args.device)
        opt = parse(args.opt, is_train=True)
        if parallel.is_initialized():
            print(f"multi-process: rank {parallel.rank()}/{parallel.world_size()}, "
                  f"device {device}, backend {parallel.backend_name()}", flush=True)
        if args.stall_timeout:
            opt["train"]["stall_timeout_s"] = args.stall_timeout
        train_from_config(opt, device=device, max_iters=args.max_iters,
                          profile_steps=args.profile_steps)
    finally:
        parallel.shutdown()
    return 0


def _cmd_train_asdqe(args) -> int:
    """The scorer's trainer (the reference's standalone Train/ASDQE.py)."""
    import math

    from .train.asdqe_trainer import train_asdqe

    if not args.param and not args.device_resident:
        print("error: --param is required unless --device-resident", file=sys.stderr)
        return 2
    device = _device(args.device)
    tracker = None
    if args.swanlab_project:
        # the reference's swanlab logging (Train/ASDQE.py:71-84); a warning
        # and no tracking where the package is missing
        from .utils.tracking import RemoteTracker

        tracker = RemoteTracker(
            "swanlab", args.swanlab_project, run_name="train-asdqe",
            config={"learning_rate": args.lr, "batch_size": args.batch_size,
                    "epochs": args.epochs, "optimizer": "Adam",
                    "loss_function": "MSE",
                    "model_architecture": "DenoiseRatePredictor"})
    result = train_asdqe(
        {"dataroot_lq": args.lq, "dataroot_gt": args.gt,
         "dataroot_param": args.param, "geometric_augs": True,
         "io_backend": {"type": "disk"}},
        lr=args.lr, epochs=args.epochs, batch_size=args.batch_size,
        accumulation_steps=args.accum, gt_size=args.gt_size, seed=args.seed,
        out_dir=args.out, max_steps_per_epoch=args.max_steps_per_epoch,
        h2d_uint8=(args.h2d == "uint8"), device_resident=args.device_resident,
        steps_per_epoch=args.steps_per_epoch, tracker=tracker, device=device)
    finite = [h["val_mse"] for h in result["history"]
              if not math.isnan(h["val_mse"])]
    if finite:  # an epoch with no validation batch reports NaN
        print(f"best val MSE: {min(finite):.6f}")
    return 0


def _cmd_test(args) -> int:
    from .data.datasets import create_dataset
    from .data.loader import BatchLoader, EnlargedShuffleSampler
    from .models import build_network
    from .train.checkpoints import load_pretrained
    from .train.config import make_exp_dirs, parse, validate
    from .train.loop import validate_model

    device = _device(args.device)
    opt = parse(args.opt, is_train=False)
    validate(opt)
    make_exp_dirs(opt)
    path = args.weights or opt["path"].get("pretrain_network_g")
    if not path:
        raise SystemExit("error: test needs --weights or "
                         "path.pretrain_network_g")
    model = load_pretrained(build_network(opt["network_g"]),
                            _resolve_weights(path)[0],
                            opt["path"].get("param_key", "params"))
    model.to(device)
    save_dir = None
    if opt.get("val", {}).get("save_img"):
        save_dir = opt["path"]["visualization"]
        os.makedirs(save_dir, exist_ok=True)
    for phase, ds_opt in opt["datasets"].items():
        ds = create_dataset(ds_opt)
        loader = BatchLoader(ds, 1, EnlargedShuffleSampler(len(ds), shuffle=False),
                             num_workers=1, drop_last=False)
        scores = validate_model(model, loader, opt, save_dir=save_dir)
        print(f"[{ds_opt.get('name', phase)}] " + ", ".join(
            f"{k}={v:.4f}" for k, v in scores.items()))
    return 0


def _tile_spec(s: str):
    """--tile / --tile-halo value: '256' (square) or '256x512' (rows x
    cols, the strip modes of denoise_tiled)."""
    if "x" in s:
        r, c = s.split("x", 1)
        return (int(r), int(c))
    return int(s)


def _resolve_weights(spec: str) -> tuple[str, float | None]:
    """A zoo alias -> its .pth, else its orbax directory (and its serving
    preset); a path passes through. An alias with neither, and a directory
    that is no orbax checkpoint, exit."""
    from .convert.orbax import METADATA, is_checkpoint

    rate = None
    path = spec
    if spec in _ZOO:
        rel, orbax_rel, rate = _ZOO[spec]
        path = os.path.join(REPO, rel)
        if not os.path.isfile(path):
            orbax_dir = os.path.join(REPO, orbax_rel)
            if not is_checkpoint(orbax_dir):
                raise SystemExit(
                    f"zoo alias '{spec}' resolves to {path} and {orbax_dir}, both "
                    f"absent in this checkout: write the .pth with `python "
                    f"{EXPORT_SCRIPT} --only {spec}` or pass an explicit --weights")
            print(f"[zoo] '{spec}': {rel} is absent; reading the orbax "
                  f"checkpoint {orbax_rel}")
            path = orbax_dir
    if os.path.isdir(path) and not is_checkpoint(path):
        raise SystemExit(
            f"{path} is a directory without {METADATA}, not an orbax checkpoint: "
            "--weights takes a reference-layout .pth, an orbax checkpoint "
            f"directory or a zoo alias ({EXPORT_SCRIPT} writes the zoo's .pth)")
    return path, rate


def _load_teacher(args):
    """The teacher of --weights as float32 (a bf16 checkpoint is upcast, as
    the JAX CLI's bf16 params promote against its float32 input), with the
    2x head only under --sr; returns (model, denoise rate)."""
    from .convert.weights import read_state_dict
    from .models import KDLAETeacher

    path, preset_rate = _resolve_weights(args.weights)
    rate = args.denoise_rate
    if rate is None:
        rate = preset_rate if preset_rate is not None else 1.0
        if preset_rate is not None and preset_rate != 1.0:
            print(f"[zoo] '{args.weights}' preset denoise_rate {preset_rate} "
                  "(override with --denoise-rate)")
    sd = read_state_dict(path, "KDLAE_teacher", args.param_key)
    has_sr = "cen.weight" in sd
    if args.sr and not has_sr:
        raise SystemExit(f"{path} has no 2x head: --sr needs one")
    model = KDLAETeacher(layernorm_type=args.layernorm_type,
                         static="train" if has_sr else "test", params="cat")
    model.load_state_dict(sd, strict=True)
    model.static = "train" if args.sr else "test"
    return model, rate


def _teacher_predictor(args):
    from .eval.infer import TeacherPredictor

    device = _device(args.device)
    model, rate = _load_teacher(args)
    return TeacherPredictor(model, shape_bucket=args.shape_bucket,
                            device=device), rate


def _cmd_infer_teacher(args) -> int:
    from .utils.image_io import imread_rgb_ubyte, imwrite, list_images

    pred, rate = _teacher_predictor(args)
    paths = ([args.input] if os.path.isfile(args.input)
             else list_images(args.input))
    os.makedirs(args.output, exist_ok=True)

    def write(p, out):
        base = os.path.basename(p)
        imwrite(os.path.join(args.output, base), out["hq"])
        if args.sr and "sr" in out:
            imwrite(os.path.join(args.output, f"sr_{base}"), out["sr"])
        print(f"{p} -> {os.path.join(args.output, base)}")

    if args.tile:
        # tiled batched path (approximate: per-tile MDTA statistics)
        imgs = [imread_rgb_ubyte(p) for p in paths]
        outs = pred.denoise_tiled(imgs, denoise_rate=rate, tile=args.tile,
                                  halo=args.tile_halo)
        for p, out in zip(paths, outs):
            write(p, out)
        return 0
    if args.group_size > 1 and len(paths) > 1:
        _stream_groups(pred, paths, args.group_size, args.shape_bucket, rate,
                       write)
        return 0
    for p in paths:
        write(p, pred.denoise_file(p, denoise_rate=rate))
    return 0


# groups in flight, and fetch-and-write threads, of _stream_groups: the JAX
# CLI's values; one upload thread dispatches the groups in order
_DEPTH = 4
_FETCH_WORKERS = 2


def _stream_groups(pred, paths, group_size, shape_bucket, denoise_rate,
                   write, read=None) -> None:
    """Serving-group streaming: images of one padded shape run as groups
    through ``dispatch_group`` / ``fetch_group`` (bit-identical to
    per-image calls). Buffers hold at most ``group_size`` decoded images
    per shape, plus ``_DEPTH`` groups in flight, so memory stays flat on
    large folders. ``read(path) -> image | None`` is injectable; a None
    skips the file (``serve`` uses this to survive mid-copy or corrupt
    inputs).

    Four stages over three host threads and the device:

      main: decode group k+2          (file IO + PNG decode)
      up-worker: prep + H2D + dispatch group k+1
      device: compute group k
      fw-worker: D2H fetch + PNG encode/write group k-1

    ``_DEPTH`` bounds the groups in flight (back-pressure and error
    propagation); two fetch workers let group k-1's encode and write
    proceed while group k's fetch waits for its compute. A group that is
    not full, or of mixed shapes, goes through ``denoise_group`` after the
    groups in flight have drained."""
    from concurrent.futures import ThreadPoolExecutor

    from .utils.image_io import imread_rgb_ubyte

    read = read or imread_rgb_ubyte

    def _key(shape):
        if shape_bucket:  # same padded shape -> same group
            b = shape_bucket
            return (-(-shape[0] // b) * b, -(-shape[1] // b) * b)
        return shape[:2]

    up_ex = ThreadPoolExecutor(max_workers=1)
    fw_ex = ThreadPoolExecutor(max_workers=_FETCH_WORKERS)
    pending: list = []  # fetch+write futures, oldest first

    def _fetch_write(grp_paths, fut):
        for p, out in zip(grp_paths, pred.fetch_group(fut.result())):
            write(p, out)

    def _drain():
        while pending:
            pending.pop(0).result()

    def _flush(items):
        imgs = [im for _, im in items]
        if pred.scan_eligible(imgs, group_size):
            fut = up_ex.submit(pred.dispatch_group, imgs,
                               denoise_rate=denoise_rate)
            pending.append(fw_ex.submit(_fetch_write, [p for p, _ in items],
                                        fut))
            while len(pending) > _DEPTH:
                pending.pop(0).result()
            return
        _drain()
        outs = pred.denoise_group(imgs, denoise_rate=denoise_rate,
                                  group_size=group_size)
        for (p, _), out in zip(items, outs):
            write(p, out)

    try:
        buffers: dict[tuple, list] = {}
        for p in paths:
            img = read(p)
            if img is None:
                continue
            buf = buffers.setdefault(_key(img.shape), [])
            buf.append((p, img))
            if len(buf) == group_size:
                _flush(buf)
                buf.clear()
        for buf in buffers.values():
            if buf:
                _flush(buf)
        _drain()
    finally:
        up_ex.shutdown(wait=True)
        fw_ex.shutdown(wait=True)
        # after a first exception, futures still pending were only awaited
        # by the shutdowns, which swallow their results: report any further
        # failure (a write error, say) rather than drop groups silently; the
        # first exception stays the one raised
        for fut in pending:
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001 - report, don't mask
                print(f"serve: pending group also failed: {e!r}",
                      file=sys.stderr)


def _cmd_serve(args) -> int:
    """Watch-folder serving daemon: poll --watch for new images, denoise
    them in groups, write results under --output with the same basenames.
    Idempotent and restart-safe: an input whose output file exists is
    skipped, so a restarted daemon (or an overlapping batch run) never
    reprocesses work. ``--once`` drains the current backlog and exits;
    ``--max-seconds`` bounds the lifetime."""
    import time

    from .utils.image_io import imread_rgb_ubyte, imwrite, list_images

    device = _device(args.device)
    if args.preflight_timeout > 0:
        # a bounded probe of the device before the daemon's first forward,
        # which would block forever on a card that does not answer
        from .utils.doctor import EXIT_BACKEND_DOWN, _probe_backend

        probe = _probe_backend(args.preflight_timeout, 1.0,
                               "cpu" if device.type == "cpu" else "")
        if probe["status"] != "ok":
            print(f"[serve] device {probe['status']}: {probe['detail']} "
                  "-- refusing to start (see `raie-torch doctor`)",
                  file=sys.stderr)
            return EXIT_BACKEND_DOWN
        print(f"[serve] preflight: {json.dumps(probe)}")

    pred, rate = _teacher_predictor(args)
    os.makedirs(args.output, exist_ok=True)
    sr_dir = os.path.join(args.output, "sr")
    if args.sr:
        os.makedirs(sr_dir, exist_ok=True)

    def _atomic_imwrite(path, img):
        # temp file + rename: a killed daemon never leaves a truncated
        # output that the done-check would then take as done (the real
        # extension stays last, so the encoder is chosen by it)
        stem, ext = os.path.splitext(path)
        tmp = stem + ".part" + ext
        imwrite(tmp, img)
        os.replace(tmp, path)

    served = [0]

    def write(p, out):
        base = os.path.basename(p)
        # sr outputs live in their own folder, so an input named
        # 'sr_x.png' cannot collide with x.png's 2x output
        if args.sr and "sr" in out:
            _atomic_imwrite(os.path.join(sr_dir, base), out["sr"])
        _atomic_imwrite(os.path.join(args.output, base), out["hq"])
        served[0] += 1
        print(f"{p} -> {os.path.join(args.output, base)}")

    def safe_read(p):
        try:
            return imread_rgb_ubyte(p)
        except Exception as exc:  # mid-copy / corrupt / vanished input
            print(f"[serve] skip {p}: {exc}")
            return None

    def _done(p):
        base = os.path.basename(p)
        if not os.path.exists(os.path.join(args.output, base)):
            return False
        return not args.sr or os.path.exists(os.path.join(sr_dir, base))

    def _stable(p):
        # only inputs untouched for a poll interval (a file still being
        # copied in would be served truncated and then skipped forever);
        # --once drains a static backlog, so no grace period there
        if args.once:
            return True
        try:
            return time.time() - os.path.getmtime(p) >= args.poll_interval
        except OSError:  # vanished between listing and stat
            return False

    deadline = (time.time() + args.max_seconds
                if args.max_seconds is not None else None)
    while True:
        backlog = [p for p in list_images(args.watch)
                   if not _done(p) and _stable(p)]
        if backlog:
            try:
                if args.tile:
                    # tiled path in bounded chunks: memory stays flat
                    for b in range(0, len(backlog), 4 * args.group_size):
                        chunk = backlog[b:b + 4 * args.group_size]
                        pairs = [(p, im) for p in chunk
                                 if (im := safe_read(p)) is not None]
                        outs = pred.denoise_tiled(
                            [im for _, im in pairs], denoise_rate=rate,
                            tile=args.tile, halo=args.tile_halo)
                        for (p, _), out in zip(pairs, outs):
                            write(p, out)
                else:
                    _stream_groups(pred, backlog, args.group_size,
                                   args.shape_bucket, rate, write,
                                   read=safe_read)
            except Exception as exc:  # noqa: BLE001 - the daemon keeps running
                # a transient runtime error must not kill an unattended
                # daemon: finished outputs are durable, the rest is retried
                print(f"[serve] batch failed ({exc!r}); retrying next poll")
        if args.once:
            break
        if deadline is not None and time.time() >= deadline:
            break
        time.sleep(args.poll_interval)
    print(f"served {served[0]} image(s)")
    return 0


def _cmd_infer_student(args) -> int:
    from .convert.weights import load_checkpoint
    from .eval.infer import StudentPredictor
    from .models import KDLAEStudent
    from .utils.image_io import imwrite

    device = _device(args.device)
    path, _ = _resolve_weights(args.weights)
    model = load_checkpoint(KDLAEStudent(residual=True, hidden_channels=(16, 32, 64)),
                            path, args.param_key)
    pred = StudentPredictor(model, num_frames=args.frames, device=device)
    if args.all:
        out = pred.denoise_all_frames(args.input)
        first = 0
    else:
        out = pred.denoise_folder(args.input, start=args.start)
        first = args.start
    os.makedirs(args.output, exist_ok=True)
    for f in range(out.shape[0]):
        imwrite(os.path.join(args.output, f"frame_{first + f:04d}.png"), out[f],
                rgb=False)
    print(f"{out.shape[0]} frames -> {args.output}")
    return 0


def _cmd_score(args) -> int:
    from .convert.weights import load_checkpoint
    from .eval.asdqe_eval import default_methods, run_asdqe_eval
    from .eval.infer import ASDQEScorer
    from .models import DenoiseRatePredictor

    device = _device(args.device)
    path = args.weights or os.path.join(REPO, _SCORER)
    if not os.path.exists(path):
        missing = args.weights or f"no --weights given and {path} is absent"
        print(f"error: checkpoint not found: {missing}", file=sys.stderr)
        return 2
    path, _ = _resolve_weights(path)
    scorer = ASDQEScorer(load_checkpoint(DenoiseRatePredictor(), path), device=device)
    if args.methods:
        methods = dict(m.split("=", 1) for m in args.methods)
        base = args.lq_dir
    else:
        base, methods = default_methods(args.sample_root, args.dataset)
    run_asdqe_eval(scorer, base, methods, csv_path=args.csv)
    return 0


def _cmd_convert(args) -> int:
    """Forward: a reference .pth -> an orbax directory in the flax layout of
    the JAX package's converters ({'params'} or, for the scorer, {'params',
    'batch_stats'}). --reverse: an orbax directory -> a reference-layout
    .pth ({'params'[, 'params_ema']}, keys sorted, dtypes kept: a bf16
    teacher stays bf16)."""
    import io

    import torch

    from .convert import orbax
    from .convert.weights import FLAX_TREES, read_pth, reference_state_dict

    if args.reverse:
        if not orbax.is_checkpoint(args.out):
            print(f"error: {args.out} is not an orbax checkpoint", file=sys.stderr)
            return 2
        restored = orbax.read_checkpoint(args.out)
        if args.arch == "DenoiseRatePredictor":
            # train-asdqe nests {'params', 'batch_stats'} under 'params'
            params, stats = orbax.asdqe_variables(restored)
            payload = {"params": reference_state_dict(params, args.arch, stats)}
        else:
            payload = {"params": reference_state_dict(
                restored.get("params", restored), args.arch)}
            if "params_ema" in restored:
                payload["params_ema"] = reference_state_dict(
                    restored["params_ema"], args.arch)
        buf = io.BytesIO()  # the bytes scripts/export_torch_zoo.py writes
        torch.save({k: {n: sd[n] for n in sorted(sd)} for k, sd in payload.items()},
                   buf)
        with open(args.pth, "wb") as fh:
            fh.write(buf.getvalue())
        print(f"exported {args.out} [{args.arch}] -> {args.pth}")
        return 0
    converted = FLAX_TREES[args.arch](read_pth(args.pth, args.param_key))
    if args.arch == "DenoiseRatePredictor":
        params, stats = converted
        payload = {"params": params, "batch_stats": stats}
    else:
        payload = {"params": converted}
    out = orbax.write_checkpoint(args.out, payload)
    print(f"converted {args.pth} [{args.arch}] -> {out}")
    return 0


def _cmd_doctor(args) -> int:
    # every device interaction runs in a child process under a timeout
    import time

    from .utils.doctor import EXIT_BACKEND_DOWN, format_report, run_doctor

    deadline = time.monotonic() + args.wait
    while True:
        report = run_doctor(probe_timeout=args.probe_timeout,
                            bandwidth_mb=args.bandwidth_mb,
                            platform=args.platform)
        healthy = report["backend"]["status"] == "ok"
        remaining = deadline - time.monotonic()
        if healthy or remaining <= 0:
            break
        # --wait: keep probing until the device answers or the budget ends,
        # then report the last probe
        print(f"[doctor] device {report['backend']['status']}; "
              f"retrying ({remaining:.0f}s of --wait left)", file=sys.stderr)
        time.sleep(min(args.poll_interval, max(1.0, remaining)))
    print(json.dumps(report) if args.json else format_report(report))
    return 0 if healthy else EXIT_BACKEND_DOWN


def _add_device(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (default; exits without a GPU) or cpu")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="raie-torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="config-driven training; resumes from the newest "
                       "training state under path.training_states, the port's "
                       "ckpt_<iter>.pth or a JAX run's ckpt_<iter>/ orbax directory "
                       "(the .pth on a tie)")
    p.add_argument("-opt", required=True)
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--profile-steps", type=int, default=0,
                   help="trace N steady steps (3 iterations after the first) "
                        "into <log>/profile and log the device ms by kernel")
    p.add_argument("--launcher", choices=["none", "env", "pytorch", "slurm"],
                   default="none",
                   help="data parallel across processes: 'env' (alias "
                        "'pytorch') reads torchrun's or SLURM's env, 'slurm' "
                        "is another alias of env (the reference's --launcher, "
                        "train.py:60); one rank per card, cuda:LOCAL_RANK")
    p.add_argument("--coordinator", default=None,
                   help="rank 0's host:port (e.g. host0:29500)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--stall-timeout", type=float, default=0,
                   help="hard-exit (code 17) when no training iteration "
                        "completes for N seconds, for a supervisor to "
                        "relaunch into auto-resume; size it above the "
                        "longest validation or checkpoint gap")
    _add_device(p)
    p.set_defaults(fn=_cmd_train)

    p = sub.add_parser("train-asdqe", help="ASDQE quality-scorer training")
    p.add_argument("--lq", required=True, help="noisy-image dir")
    p.add_argument("--gt", required=True, help="result-image dir")
    p.add_argument("--param", default=None, help="per-image JSON score dir")
    p.add_argument("--out", required=True, help="weights output dir "
                   "(net_g_<epoch>.pth, net_g_best.pth)")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--accum", type=int, default=32)
    p.add_argument("--gt-size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-steps-per-epoch", type=int, default=None)
    p.add_argument("--h2d", choices=("uint8", "f32"), default="uint8",
                   help="device input boundary (uint8: 4x less transfer)")
    p.add_argument("--device-resident", action="store_true",
                   help="hold the (origin, denoised) sources in device memory "
                        "and mix the graded candidates there; --param not needed")
    p.add_argument("--swanlab-project", default=None,
                   help="log per-epoch metrics to this swanlab project")
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="the device-resident corpus's epoch size (with "
                        "--device-resident only)")
    _add_device(p)
    p.set_defaults(fn=_cmd_train_asdqe)

    p = sub.add_parser("test", help="config-driven offline eval")
    p.add_argument("-opt", required=True)
    p.add_argument("--weights", default=None,
                   help="net_g_*.pth or an orbax directory (default: "
                        "path.pretrain_network_g)")
    _add_device(p)
    p.set_defaults(fn=_cmd_test)

    p = sub.add_parser("infer-teacher", help="KDLAE-T whole-image denoise")
    p.add_argument("--weights", required=True,
                   help="reference-layout .pth, orbax directory, or a zoo alias: "
                        + " / ".join(k for k in _ZOO if "teacher" in k))
    p.add_argument("--input", required=True, help="image file or folder")
    p.add_argument("--output", required=True)
    p.add_argument("--denoise-rate", type=float, default=None,
                   help="conditioning strength (default 1.0; the "
                        "teacher-l2dice zoo alias presets 0.6)")
    p.add_argument("--sr", action="store_true", help="also emit the 2x output")
    p.add_argument("--layernorm-type", default="BiasFree")
    p.add_argument("--param-key", default="params")
    p.add_argument("--group-size", type=int, default=1,
                   help=">1 serves same-shape images in groups "
                        "(throughput mode, outputs unchanged)")
    p.add_argument("--shape-bucket", type=int, default=None,
                   help="round padded sizes up to this grid so mixed-size "
                        "folders share groups (approximate)")
    p.add_argument("--tile", type=_tile_spec, default=None,
                   help="tiled batched serving: TILE-px interiors, 8 per "
                        "call (approximate: per-tile attention statistics)")
    p.add_argument("--tile-halo", type=_tile_spec, default=0,
                   help="context ring around each tile interior (px, or "
                        "ROWSxCOLS per axis, e.g. 8x0 for strips)")
    _add_device(p)
    p.set_defaults(fn=_cmd_infer_teacher)

    p = sub.add_parser("serve", help="watch-folder serving daemon")
    p.add_argument("--weights", required=True,
                   help="reference-layout .pth, orbax directory, or a zoo alias: "
                        + " / ".join(k for k in _ZOO if "teacher" in k))
    p.add_argument("--watch", required=True, help="input folder to poll")
    p.add_argument("--output", required=True)
    p.add_argument("--denoise-rate", type=float, default=None)
    p.add_argument("--sr", action="store_true")
    p.add_argument("--layernorm-type", default="BiasFree")
    p.add_argument("--param-key", default="params")
    p.add_argument("--group-size", type=int, default=8)
    p.add_argument("--shape-bucket", type=int, default=None)
    p.add_argument("--poll-interval", type=float, default=2.0)
    p.add_argument("--once", action="store_true",
                   help="drain the current backlog and exit")
    p.add_argument("--max-seconds", type=float, default=None)
    p.add_argument("--preflight-timeout", type=float, default=120.0,
                   help="bounded device probe before starting (a card that "
                        "does not answer would hang the first forward); "
                        "0 disables")
    p.add_argument("--tile", type=_tile_spec, default=None,
                   help="tiled batched serving (see infer-teacher --tile)")
    p.add_argument("--tile-halo", type=_tile_spec, default=0)
    _add_device(p)
    p.set_defaults(fn=_cmd_serve)

    p = sub.add_parser("infer-student", help="KDLAE-S multi-frame denoise")
    p.add_argument("--weights", required=True,
                   help="reference-layout .pth, orbax directory, or a zoo alias: "
                        + " / ".join(k for k in _ZOO if "student" in k))
    p.add_argument("--input", required=True, help="frame folder")
    p.add_argument("--output", required=True)
    p.add_argument("--frames", type=int, default=7)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--all", action="store_true",
                   help="denoise every frame of the folder (consecutive "
                        "stacks, overlapping tail) instead of one stack at "
                        "--start")
    p.add_argument("--param-key", default="params")
    _add_device(p)
    p.set_defaults(fn=_cmd_infer_student)

    p = sub.add_parser("score", help="ASDQE scoring protocol")
    p.add_argument("--weights", default=None,
                   help=f"scorer .pth or orbax directory; default: the trained "
                        f"scorer {_SCORER}")
    p.add_argument("--sample-root", default="Sample")
    p.add_argument("--dataset", default="MDD")
    p.add_argument("--lq-dir", default=None)
    p.add_argument("--methods", nargs="*", default=None,
                   help="name=dir pairs (default: the reference protocol)")
    p.add_argument("--csv", default="stats_transposed.csv")
    _add_device(p)
    p.set_defaults(fn=_cmd_score)

    p = sub.add_parser("convert", help="reference .pth <-> orbax checkpoint")
    p.add_argument("--pth", required=True,
                   help="the .pth side (input, or output with --reverse)")
    p.add_argument("--arch", required=True, choices=ARCHS)
    p.add_argument("--out", required=True,
                   help="the orbax side (output, or input with --reverse)")
    p.add_argument("--param-key", default="params")
    p.add_argument("--reverse", action="store_true",
                   help="export: orbax checkpoint dir -> reference-layout "
                        ".pth (params + params_ema when present)")
    p.set_defaults(fn=_cmd_convert)

    p = sub.add_parser("doctor", help="device diagnostics: health, dispatch "
                       "time, transfer rates (bounded child-process probe)")
    p.add_argument("--probe-timeout", type=float, default=120.0,
                   help="seconds before the device is declared wedged")
    p.add_argument("--bandwidth-mb", type=float, default=8.0,
                   help="transfer probe size (one H2D + one D2H)")
    p.add_argument("--platform", default="",
                   help="'cpu' probes the CPU instead of the GPU")
    p.add_argument("--wait", type=float, default=0.0,
                   help="keep re-probing an unhealthy device for up to N "
                        "seconds (exit 0 the moment it answers)")
    p.add_argument("--poll-interval", type=float, default=300.0,
                   help="seconds between --wait probes")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=_cmd_doctor)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
