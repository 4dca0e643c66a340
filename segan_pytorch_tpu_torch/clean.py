"""Enhancement CLI of the port, with the argparse surface and outputs of the repo's
``clean.py``: rebuild G from a train.opts JSON, load its checkpoint, and enhance every
wav of --test_files (chunked SEGAN inference) into --synthesis_path.

    python -m segan_pytorch_tpu_torch.clean --g_pretrained_ckpt G.ckpt \\
        --cfg_file train.opts --test_files noisy_dir --synthesis_path out --soundfile

It runs on the CUDA card, and raises without one; ``--device cpu`` asks for the CPU (the
port's counterpart of ``JAX_PLATFORMS=cpu``).
"""
import argparse
import glob
import os
import random
import timeit

import numpy as np
import torch


def main(opts):
    if opts.cfg_file is None or opts.test_files is None or opts.g_pretrained_ckpt is None:
        raise ValueError("--cfg_file, --test_files and --g_pretrained_ckpt are required")

    from .data.wav_io import read_wav_raw, write_wav
    from .ops.signal import normalize_wave_minmax, pre_emphasize_np
    from .utils.engine import build_enhancement_engine

    cfg, segan = build_enhancement_engine(opts.cfg_file, opts.g_pretrained_ckpt,
                                          opts.seed, device=opts.device)
    print('Loaded train config: ')
    print(cfg.to_json())

    if opts.h5:
        import h5py

        # the noisy chunks ('label'), stored already normalized and pre-emphasized
        with h5py.File(opts.test_files[0], 'r') as f:
            key = 'label' if 'label' in f else 'data'
            twavs = f[key][:]
    elif len(opts.test_files) == 1:
        twavs = sorted(glob.glob(os.path.join(opts.test_files[0], '*.wav')))
    else:
        twavs = opts.test_files
    print('Cleaning {} wavs'.format(len(twavs)))

    subtype = 'pcm16' if opts.soundfile else 'float'

    def _load(twav):
        _, wav = read_wav_raw(twav)
        return pre_emphasize_np(normalize_wave_minmax(wav), cfg.preemph)

    B = max(1, int(opts.batch_utts))
    if B > 1 and not opts.h5:
        # throughput mode: the chunk grids of B utterances go through G as one batch
        beg_t = timeit.default_timer()
        for lo in range(0, len(twavs), B):
            group = twavs[lo: lo + B]
            results = segan.generate_batch([_load(t) for t in group],
                                           overlap=opts.overlap)
            for twav, (g_wav, _) in zip(group, results):
                write_wav(os.path.join(opts.synthesis_path, os.path.basename(twav)),
                          g_wav, 16000, subtype=subtype)
            end_t = timeit.default_timer()
            print('Cleaned {}/{} (batch of {}) in {} s'.format(
                min(lo + B, len(twavs)), len(twavs), len(group), end_t - beg_t))
            beg_t = timeit.default_timer()
        return

    beg_t = timeit.default_timer()
    for t_i, twav in enumerate(twavs, start=1):
        if opts.h5:
            tbname = 'tfile_{}.wav'.format(t_i)
            wav = np.asarray(twav, np.float32).reshape(-1)
            twav = tbname
        else:
            tbname = os.path.basename(twav)
            wav = _load(twav)
        g_wav, _ = segan.generate(wav, overlap=opts.overlap)
        write_wav(os.path.join(opts.synthesis_path, tbname), g_wav, 16000,
                  subtype=subtype)
        end_t = timeit.default_timer()
        print('Cleaned {}/{}: {} in {} s'.format(t_i, len(twavs), twav, end_t - beg_t))
        beg_t = timeit.default_timer()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument('--g_pretrained_ckpt', type=str, default=None)
    parser.add_argument('--test_files', type=str, nargs='+', default=None)
    parser.add_argument('--h5', action='store_true', default=False)
    parser.add_argument('--seed', type=int, default=111)
    parser.add_argument('--overlap', type=float, default=0.0,
                        help='chunk overlap fraction in [0, 0.5): cross-fade '
                             'overlapping enhanced chunks (hann overlap-add) '
                             'instead of hard chunk boundaries; 0 = '
                             'reference-exact concatenation')
    parser.add_argument('--batch_utts', type=int, default=1,
                        help='>1: enhance this many utterances per device pass '
                             '(their chunk grids concatenate into ONE batch). '
                             'Throughput mode for large offline jobs.')
    parser.add_argument('--synthesis_path', type=str, default='segan_samples')
    parser.add_argument('--soundfile', action='store_true', default=False,
                        help='Write PCM16 wavs (like the ref soundfile path)')
    parser.add_argument('--cfg_file', type=str, default=None)
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help='cuda (the default) needs a card; cpu runs the plain '
                             'PyTorch versions of the kernels')
    return parser


if __name__ == '__main__':
    opts = build_parser().parse_args()
    os.makedirs(opts.synthesis_path, exist_ok=True)
    random.seed(opts.seed)
    np.random.seed(opts.seed)
    torch.manual_seed(opts.seed)
    main(opts)
