"""Convert checkpoints between the torch reference format and the JAX package's npz
trees: the counterpart of the repo's ``weight_converter.py``, with its two directions.

    python -m segan_pytorch_tpu_torch.weight_converter <torch ckpt> [--out out.npz] \\
        [--which G|D] [--dpool_slen 16] [--last_fmaps 1024]
    python -m segan_pytorch_tpu_torch.weight_converter <npz ckpt> --to_torch \\
        [--out out.ckpt] [--which G|D] [--dpool_slen 16] [--last_fmaps 1024]

By default a reference-format torch ``.ckpt`` (upstream's, the port's, or one with the
legacy 'gen_enc'/'gen_dec' names) becomes the JAX variables tree saved as
``{"state_dict": tree}`` with meta ``{"source": <ckpt>}`` (``utils/checkpoint.py``
``generator_tree_from_torch`` / ``discriminator_tree_from_torch``), the same arrays as
the JAX tool writes. ``--to_torch`` turns such a tree (or the JAX trainer's checkpoint)
back into upstream's ``torch.save({'step', 'state_dict'})``, the step from its meta,
through the port's own bridges (``generator_state_from_jax`` /
``discriminator_state_from_jax``): it loads strictly into the port's G or D.
``--dpool_slen`` and ``--last_fmaps`` give D's 'none' head its flatten shape.

One difference from the JAX tool: a sinc D's filter bank ('sinc_conv.filt_b1',
'filt_band') is carried both ways under the JAX variable names, where the JAX converter
drops it. The tool runs on the host; it builds no model.
"""
import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument('ckpt_file', type=str)
    parser.add_argument('--out', type=str, default=None)
    parser.add_argument('--which', type=str, default='G', choices=['G', 'D'])
    parser.add_argument('--to_torch', action='store_true', default=False,
                        help='reverse direction: framework npz ckpt -> '
                             'reference torch format')
    parser.add_argument('--dpool_slen', type=int, default=16)
    parser.add_argument('--last_fmaps', type=int, default=1024)
    return parser


def main(argv=None) -> str:
    """Convert; returns the path written."""
    opts = build_parser().parse_args(argv)
    from .utils.checkpoint import (discriminator_state_from_jax,
                                   discriminator_tree_from_torch, export_torch, flatten_tree,
                                   generator_state_from_jax, generator_tree_from_torch,
                                   load_pytree, read_torch_state, save_pytree)

    if opts.to_torch:
        payload, meta = load_pytree(opts.ckpt_file)
        flat = flatten_tree(payload.get('state_dict', payload))
        step = int((meta or {}).get('step', 0))
        out = opts.out or (opts.ckpt_file + '.torch')
        if opts.which == 'G':
            state = generator_state_from_jax(flat)
        else:
            state = discriminator_state_from_jax(flat, opts.dpool_slen, opts.last_fmaps)
        export_torch(state, out, step=step)
        print(f'Wrote {out}')
        return out

    st = read_torch_state(opts.ckpt_file)
    if opts.which == 'G':
        tree = generator_tree_from_torch(st)
    else:
        tree = discriminator_tree_from_torch(st, opts.dpool_slen, opts.last_fmaps)
    out = opts.out or (opts.ckpt_file + '.jax')
    save_pytree(out, {"state_dict": tree}, meta={"source": opts.ckpt_file})
    if os.path.exists(out + '.npz'):
        os.replace(out + '.npz', out)
    print(f'Wrote {out}')
    return out


if __name__ == '__main__':
    main()
