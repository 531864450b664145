"""mapdn_torch's rendering (``mapdn_torch.envs.rendering``) on the CPU:
``render`` against the JAX package's on the same float64 grid state (the
same figure, pixel for pixel), ``pf_res_plot``'s PNG and HTML,
``render_record``'s frame bound and GIF, and the wrapper's ``render`` and
``res_pf_plot``."""
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from mapdn_torch.envs import EnvConfig, VoltageControlWrapper, make_env
from mapdn_torch.envs import rendering
from mapdn_tpu.envs import EnvConfig as JaxEnvConfig
from mapdn_tpu.envs import make_env as jax_make_env
from mapdn_tpu.envs import rendering as jax_rendering

torch.set_num_threads(1)

PNG = b"\x89PNG\r\n\x1a\n"


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    # numpy's OpenBLAS spins 8 threads in each of Tier-1's 6 xdist workers
    # on 8 cores; one thread a worker keeps the workers from stalling each
    # other (the port's files ran about 5x faster so)
    with threadpool_limits(1, user_api="blas"):
        yield


@pytest.fixture(scope="module")
def env_state():
    """A case33 state at float64 on the CPU: two lanes (days 3 and 4 at
    noon), so that ``lane`` picks a row."""
    env = make_env("case33", EnvConfig(), days=8, dtype=torch.float64, device="cpu")
    state, _, _ = env.manual_reset(torch.tensor([3, 4]), 12, 0)
    return env, state


def _is_png(path):
    with open(path, "rb") as fh:
        return fh.read(8) == PNG


@pytest.mark.parametrize("lane", [0, 1])
def test_render_matches_jax_pixel_for_pixel(env_state, lane):
    """One lane of the port's batched state against the JAX package's
    ``render`` of that lane's values (an unbatched state): the same frame,
    every pixel."""
    env, state = env_state
    jenv = jax_make_env("case33", JaxEnvConfig(), days=8, dtype=jnp.float64)
    one = SimpleNamespace(**{f: jnp.asarray(getattr(state, f)[lane].numpy())
                             for f in ("vm", "pl_mw", "sgen_q", "pv_p")})
    got = rendering.render(env, state, lane=lane)
    want = jax_rendering.render(jenv, one)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape and got.shape[2] == 3
    np.testing.assert_array_equal(got, want)
    assert got.std() > 0                  # a drawn frame, not a blank one


def test_pf_res_plot_writes_png_and_html(env_state, tmp_path):
    env, state = env_state
    path = str(tmp_path / "plots" / "pf_res_plot")
    png = rendering.pf_res_plot(env, state, path, lane=1)
    assert png == path + ".png" and _is_png(png)
    with open(path + ".html") as fh:
        html = fh.read()
    assert html.startswith("<html><body><img src='data:image/png;base64,")


def _record(env, state, n):
    """A tester-like single-day record of ``n`` visited states (the
    lane's state, its voltages nudged a little each step)."""
    row = lambda f: getattr(state, f)[0].numpy()
    return {"bus_voltage": [row("vm") + 1e-3 * i for i in range(n)],
            "line_loss": [row("pl_mw")] * n, "pv_reactive": [row("sgen_q")] * n,
            "pv_active": [row("pv_p")] * n}


@pytest.mark.parametrize("n,max_frames,want", [(95, 48, 48), (5, 48, 5)])
def test_render_record_bounds_its_frames(env_state, tmp_path, n, max_frames, want):
    """At most ``max_frames`` frames, evenly spaced (every ceil(n /
    max_frames)-th step): at n = 95 the JAX package's floor division draws
    all 95."""
    env, state = env_state
    paths = rendering.render_record(env, _record(env, state, n), str(tmp_path),
                                    max_frames=max_frames, dpi=20, gif=False)
    assert len(paths) == want <= max_frames
    every = -(-n // max_frames)
    assert paths == [str(tmp_path / f"step_{i:04d}.png") for i in range(0, n, every)]
    assert all(_is_png(p) for p in paths)
    assert not os.path.exists(tmp_path / "replay.gif")


def test_render_record_writes_a_gif(env_state, tmp_path):
    from PIL import Image

    env, state = env_state
    paths = rendering.render_record(env, _record(env, state, 6), str(tmp_path),
                                    max_frames=3, dpi=20)
    assert len(paths) == 3
    with Image.open(tmp_path / "replay.gif") as gif:
        assert gif.format == "GIF" and gif.n_frames == 3


def test_wrapper_render_and_res_pf_plot(tmp_path):
    """The wrapper draws its one lane: an RGB frame, and the plot's PNG."""
    env = VoltageControlWrapper("case33", days=8, device="cpu")
    env.reset()
    frame = env.render()
    assert frame.dtype == np.uint8 and frame.ndim == 3 and frame.shape[2] == 3
    png = env.res_pf_plot(str(tmp_path / "pf"))
    assert png == str(tmp_path / "pf.png") and _is_png(png)
    assert os.path.isfile(tmp_path / "pf.html")
