"""Grid-state rendering: voltage heatmap and line loading plots (PyTorch port
of mapdn_tpu/envs/rendering.py).

The reference renders with a pyglet window showing a plotly-generated JPEG
(rendering_voltage_control_env.py:60-133, pf_res_plot.py:22-177); this
package draws the same figure as the JAX package, on matplotlib:

* ``render(env, state, mode='rgb_array')`` -> HxWx3 uint8 frame (the
  reference Viewer's rgb_array mode),
* ``pf_res_plot(env, state, path)`` -> PNG and a self-contained HTML file
  of the network heatmap (bus colour = vm_pu, edge width = loss), the
  analogue of reference voltage_control_env.py:659-674,
* ``render_record(env, record, outdir)`` -> PNG frames (and a GIF) of a
  tester's single-day record.

The env's states are batched: the figure shows one lane (``lane=0``),
copied to the host.  matplotlib, and Pillow for the GIF, are imported
where they are used, so the package imports without them.
"""
from __future__ import annotations

import base64
import io
import os
from types import SimpleNamespace

import numpy as np


def _tree_layout(n_bus, f_bus, t_bus):
    """Deterministic radial tree layout: depth -> x, subtree order -> y."""
    children = {i: [] for i in range(n_bus)}
    for f, t in zip(f_bus, t_bus):
        children[int(f)].append(int(t))
    pos = {}
    next_y = [0.0]

    def place(node, depth):
        kids = children[node]
        if not kids:
            y = next_y[0]
            next_y[0] += 1.0
        else:
            ys = [place(k, depth + 1) for k in kids]
            y = float(np.mean(ys))
        pos[node] = (float(depth), y)
        return y

    place(0, 0)
    # any disconnected buses (shouldn't happen) at the origin column
    for i in range(n_bus):
        pos.setdefault(i, (0.0, float(i)))
    return pos


def _host(x, lane):
    """One lane's row of a batched tensor (or array) as a numpy array."""
    return np.asarray(x[lane].detach().cpu().numpy() if hasattr(x, "detach") else x[lane])


def make_figure(env, state, lane=0, *, climits_volt=(0.9, 1.1), figsize=(11, 7)):
    """Matplotlib Figure of one lane of a grid state (any object with
    batched ``vm``, ``pl_mw``, ``sgen_q`` and ``pv_p``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.collections import LineCollection

    grid = env.grid
    f_bus = grid.f_bus.cpu().numpy()
    t_bus = grid.t_bus.cpu().numpy()
    vm = _host(state.vm, lane)
    pl = _host(state.pl_mw, lane)
    q = _host(state.sgen_q, lane)
    pv = _host(state.pv_p, lane)
    sgen_bus = grid.sgen_bus.cpu().numpy()

    pos = _tree_layout(grid.n_bus, f_bus, t_bus)
    xy = np.array([pos[i] for i in range(grid.n_bus)])

    fig, ax = plt.subplots(figsize=figsize)
    segs = [[pos[int(f)], pos[int(t)]] for f, t in zip(f_bus, t_bus)]
    widths = 1.0 + 6.0 * (pl / (pl.max() + 1e-9))
    lc = LineCollection(segs, linewidths=widths, colors="0.55", zorder=1)
    ax.add_collection(lc)

    sc = ax.scatter(xy[:, 0], xy[:, 1], c=vm, cmap="coolwarm",
                    vmin=climits_volt[0], vmax=climits_volt[1],
                    s=60, zorder=2, edgecolors="k", linewidths=0.4)
    ax.scatter(xy[sgen_bus, 0], xy[sgen_bus, 1], marker="^", s=160,
               facecolors="none", edgecolors="green", linewidths=1.6,
               zorder=3, label="PV inverter")
    ax.scatter([xy[0, 0]], [xy[0, 1]], marker="s", s=160, facecolors="none",
               edgecolors="purple", linewidths=1.6, zorder=3, label="slack")
    fig.colorbar(sc, ax=ax, label="bus voltage [pu]")
    total_loss = float(pl.sum())
    ax.set_title(f"{grid.name}: total line loss {total_loss:.4f} MW, "
                 f"PV {pv.sum():.2f} MW / q {q.sum():+.2f} Mvar")
    ax.legend(loc="lower right")
    ax.set_axis_off()
    fig.tight_layout()
    return fig


def render(env, state, mode="rgb_array", lane=0):
    """RGB frame of one lane of the grid state (reference Viewer.render
    analogue)."""
    fig = make_figure(env, state, lane)
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=100)
    import matplotlib.pyplot as plt
    plt.close(fig)
    buf.seek(0)
    from matplotlib.image import imread
    return (imread(buf) * 255).astype(np.uint8)[..., :3]


def pf_res_plot(env, state, path="pf_res_plot", lane=0, **kw):
    """Write <path>.png and a self-contained <path>.html of one lane
    (reference res_pf_plot, voltage_control_env.py:659-674)."""
    fig = make_figure(env, state, lane, **kw)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    png_path = path + ".png"
    fig.savefig(png_path, dpi=120)
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=120)
    import matplotlib.pyplot as plt
    plt.close(fig)
    b64 = base64.b64encode(buf.getvalue()).decode()
    with open(path + ".html", "w") as f:
        f.write(f"<html><body><img src='data:image/png;base64,{b64}'/>"
                "</body></html>")
    return png_path


def render_record(env, record, outdir, *, max_frames=48, dpi=100, gif=True):
    """Render a tester's single-day record (``PGTester.run``: one numpy
    array a visited state in each of ``bus_voltage``, ``line_loss``,
    ``pv_reactive`` and ``pv_active``) to PNG frames, and with ``gif=True``
    (where Pillow is installed) to ``<outdir>/replay.gif``.  At most
    ``max_frames`` evenly spaced steps are drawn: every ceil(n /
    max_frames)-th (the JAX package's floor division draws up to twice as
    many).  Returns the list of written frame paths."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(record["bus_voltage"])
    every = -(-n // max_frames)
    os.makedirs(outdir, exist_ok=True)
    paths = []
    for i in range(0, n, every):
        view = SimpleNamespace(
            vm=record["bus_voltage"][i][None], pl_mw=record["line_loss"][i][None],
            sgen_q=record["pv_reactive"][i][None], pv_p=record["pv_active"][i][None])
        fig = make_figure(env, view)
        path = os.path.join(outdir, f"step_{i:04d}.png")
        fig.savefig(path, dpi=dpi)
        plt.close(fig)
        paths.append(path)
    if gif and paths:
        try:
            from PIL import Image
        except ImportError:
            return paths
        imgs = [Image.open(p).convert("P", palette=Image.ADAPTIVE)
                for p in paths]
        imgs[0].save(os.path.join(outdir, "replay.gif"), save_all=True,
                     append_images=imgs[1:], duration=150, loop=0)
    return paths
