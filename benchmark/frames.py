"""The one generator of the benchmark's frames, made on the device from a
seed and a traffic mix's parameters.

A stream is a seeded texture (uniform noise, box-smoothed twice along
each axis) seen through a moving camera:

* motion "circle": on a closed sub-pixel circle, with blocks of fresh
  smoothed noise (the vehicles) crossing the view at fixed speeds.  A
  stream's pool of `pool` frames replays without a jump of the texture:
  frame `pool` is frame 0 again, so a clip of pool + 1 frames can run
  again and again;
* motion "sweep": `frames` frames of a camera that sweeps sideways, back
  and forth, in front of a scene of two depths: a far wall and near
  posts (vertical bars of their own texture, `post_px` wide every
  `post_px + gap_px`).  The near layer moves `near_px` pixels a frame
  and the far one `far_px` (their depths are in that ratio, inversely),
  on a triangle path of `sweep_px` pixels either side of the start (of
  the near layer).  So features leave the view and are hidden by the
  posts, keyframes open by overlap, and the two depths' parallax tells a
  translation of the camera from a rotation.

Every seed gets the same motion and the same blocks: stream s takes the
traffic file's speeds and phases (the share of its crossing a block has
made at frame 0) rotated by s, with its lanes and directions; every
texture is brought to one mean and contrast.  Where the mix names a
`texture_seed`, the textures come from it, and the run's seed draws the
order of the streams and the frame each stream's pool starts from: every
seed then runs the same set of frames in another order, so the seed
changes the order and the checked steps, not the amount of work (the
textures alone moved the farm's rate by 7% from seed to seed).
Otherwise the run's seed draws the textures.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


# every texture's standard deviation (grey levels) about a mean of 127.5
CONTRAST = 32.0


def smoothed_noise(rows: int, cols: int, g: torch.Generator, device,
                   box: int = 5) -> torch.Tensor:
    """f32 [rows, cols] in [0, 255]: uniform noise box-smoothed twice
    along each axis, brought to a mean of 127.5 and a standard deviation
    of CONTRAST."""
    pad = 2 * box
    tex = torch.rand((1, 1, rows + 2 * pad, cols + 2 * pad), generator=g,
                     device=device) * 255.0
    for _ in range(2):
        tex = F.avg_pool2d(tex, (1, box), stride=1)
        tex = F.avg_pool2d(tex, (box, 1), stride=1)
    tex = tex[0, 0]
    r0 = (tex.shape[0] - rows) // 2
    c0 = (tex.shape[1] - cols) // 2
    tex = tex[r0:r0 + rows, c0:c0 + cols]
    tex = (tex - tex.mean()) / tex.std() * CONTRAST + 127.5
    return tex.clamp(0.0, 255.0)


def _sample(tex: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor
            ) -> torch.Tensor:
    """Bilinear samples of tex at (sx, sy), all in range."""
    x0, y0 = sx.floor().long(), sy.floor().long()
    fx, fy = sx - x0, sy - y0
    w = tex.shape[1]
    flat = tex.reshape(-1)

    def at(dy, dx):
        return flat[(y0 + dy) * w + (x0 + dx)]

    return ((1 - fx) * (1 - fy) * at(0, 0) + fx * (1 - fy) * at(0, 1) +
            (1 - fx) * fy * at(1, 0) + fx * fy * at(1, 1))


def _triangle(k: torch.Tensor, amp: float) -> torch.Tensor:
    """A path that goes from 0 up to amp, down to -amp and back, 1 a
    step (k: steps)."""
    ph = torch.remainder(k + amp, 4 * amp)
    return amp - (ph - 2 * amp).abs()


def sweep(width: int, height: int, p: dict, g: torch.Generator, device
          ) -> torch.Tensor:
    """u8 [frames, height, width]: the two-depth scene under the sweep."""
    n, near, far = int(p["frames"]), float(p["near_px"]), float(p["far_px"])
    amp, post, gap = float(p["sweep_px"]), int(p["post_px"]), int(p["gap_px"])
    pad = int(math.ceil(amp)) + 2
    # a row more than the frame: the bilinear samples read one row down
    wall = smoothed_noise(height + 1, width + 2 * pad, g, device)
    posts = smoothed_noise(height + 1, width + 2 * pad, g, device)
    k = torch.arange(n, device=device, dtype=torch.float32)
    pos = _triangle(k * near, amp)                 # near layer, px
    xx = torch.arange(width, device=device, dtype=torch.float32)
    yy = torch.arange(height, device=device, dtype=torch.float32)[:, None]
    out = torch.empty((n, height, width), dtype=torch.uint8, device=device)
    for i in range(n):
        xn = xx + pad + pos[i]
        xf = xx + pad + pos[i] * (far / near)
        on_post = torch.remainder(xn.floor(), post + gap) < post
        img = torch.where(on_post[None, :],
                          _sample(posts, xn.expand(height, width),
                                  yy.expand(height, width)),
                          _sample(wall, xf.expand(height, width),
                                  yy.expand(height, width)))
        out[i] = img.round().clamp(0, 255).to(torch.uint8)
    return out


def stream(width: int, height: int, p: dict, g: torch.Generator, device,
           index: int = 0) -> torch.Tensor:
    """Stream `index`'s frames: u8 [pool + 1, height, width] of the
    circle, or [frames, height, width] of the sweep."""
    if p.get("motion", "circle") == "sweep":
        return sweep(width, height, p, g, device)
    pool, radius = int(p["pool"]), float(p["circle_radius"])
    margin = int(math.ceil(radius)) + 2
    tex = smoothed_noise(height + 2 * margin, width + 2 * margin, g, device)
    t = torch.arange(pool, device=device, dtype=torch.float32)
    ang = 2.0 * math.pi * t / pool
    dx = (radius * torch.cos(ang))[:, None, None]
    dy = (radius * torch.sin(ang))[:, None, None]
    yy = torch.arange(height, device=device, dtype=torch.float32)[None, :,
                                                                  None]
    xx = torch.arange(width, device=device, dtype=torch.float32)[None, None,
                                                                 :]
    img = _sample(tex, (xx + margin + dx).expand(pool, height, width),
                  (yy + margin + dy).expand(pool, height, width))

    blocks = p["blocks"]
    n = len(blocks["speeds"])
    turn = [(b + index) % n for b in range(n)]
    speeds = [blocks["speeds"][i] for i in turn]
    lanes, dirs = blocks["lanes"], blocks["directions"]
    bw, bh = int(blocks["width"]), int(blocks["height"])
    span = width + bw
    phase = [blocks["phases"][i] * span for i in turn]
    cols = torch.arange(width, device=device)
    for b in range(n):
        btex = smoothed_noise(bh, bw, g, device)
        y0 = int(round(lanes[b] * (height - bh)))
        bx = torch.remainder(phase[b] + dirs[b] * speeds[b] * t,
                             span).round().long() - bw          # [pool]
        col = cols[None, :] - bx[:, None]                       # [pool, W]
        inside = (col >= 0) & (col < bw)
        patch = btex[:, col.clamp(0, bw - 1)].permute(1, 0, 2)  # [pool,bh,W]
        rows = img[:, y0:y0 + bh, :]
        img[:, y0:y0 + bh, :] = torch.where(inside[:, None, :],
                                            patch[:, :rows.shape[1]], rows)
    frames = img.round().clamp(0, 255).to(torch.uint8)
    return torch.cat([frames, frames[:1]])


def streams(width: int, height: int, p: dict, seed: int, device
            ) -> torch.Tensor:
    """u8 [streams, frames, height, width] (module docstring)."""
    n = int(p["streams"])
    fixed = "texture_seed" in p
    g = generator(p["texture_seed"] if fixed else seed, device)
    out = torch.stack([stream(width, height, p, g, device, s)
                       for s in range(n)])
    if not fixed:
        return out
    g = generator(seed, device)
    order = torch.randperm(n, generator=g, device=device)
    start = torch.randint(0, int(p["pool"]), (n,), generator=g,
                          device=device).tolist()
    out = out[order]
    for s in range(n):          # a pool is a cycle: frame `pool` = frame 0
        pool = out[s, :-1].roll(-start[s], dims=0)
        out[s] = torch.cat([pool, pool[:1]])
    return out
