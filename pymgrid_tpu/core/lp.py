"""Batched linear programming on the device: a PDLP-style first-order solver.

Solves batches of LPs sharing one constraint structure:

    min c'x   s.t.   K_eq x = b,   K_in x <= h,   x >= 0

with per-problem ``(c, b, h)`` and shared ``(K_eq, K_in)`` — exactly the
receding-horizon MPC shape (static block matrices, time-varying right-hand
sides; see :mod:`pymgrid_tpu.algos.mpc`).  The method is primal-dual hybrid
gradient (Chambolle-Pock) with Ruiz diagonal preconditioning and ergodic
averaging, the same family as cuPDLP/PDLP.  Per iteration the whole batch
does two dense matmuls against the shared constraint matrix, so thousands
of horizon problems solve concurrently per device.

Accuracy is first-order (~1e-4..1e-6 relative with the default iteration
budget on MPC-sized problems); use scipy/HiGHS (:mod:`pymgrid_tpu.algos.mpc`)
when simplex-exact vertices are required.
"""
import numpy as np

__all__ = ["ruiz_scale", "make_batched_lp_solver", "make_batched_ipm_solver", "make_batched_box_ipm_solver"]


def ruiz_scale(K, iters=10):
    """Ruiz equilibration: diagonal row/col scalings D_r K D_c with rows and
    columns brought toward unit infinity-norm."""
    K = np.asarray(K, dtype=np.float64)
    m, n = K.shape
    d_r = np.ones(m)
    d_c = np.ones(n)
    M = K.copy()
    for _ in range(iters):
        row_norm = np.sqrt(np.maximum(np.abs(M).max(axis=1), 1e-12))
        col_norm = np.sqrt(np.maximum(np.abs(M).max(axis=0), 1e-12))
        d_r /= row_norm
        d_c /= col_norm
        M = K * d_r[:, None] * d_c[None, :]
    return M, d_r, d_c


def make_batched_ipm_solver(K_eq, K_in, iters=35, dtype=np.float64, x_scale=None,
                            newton_refine=None, matmul_precision="float32",
                            solve_mode="triangular"):
    """Batched Mehrotra predictor-corrector interior-point LP solver.

    Same problem family as :func:`make_batched_lp_solver` (shared constraint
    structure, batched ``(c, b, h)``), in standard form with slacks:

        min c'x  s.t.  A [x; s] = [b; h],  [x; s] >= 0,
        A = [[K_eq, 0], [K_in, I]]

    Per iteration every problem forms the normal-equations matrix
    ``A diag(x/z) A'`` (one batched matmul), factorizes it with a
    batched Cholesky, and takes Mehrotra's predictor + corrector steps
    (reusing the factorization).  Converges to ~1e-8 relative accuracy in
    ~25-35 iterations independent of problem conditioning — unlike
    first-order methods, which is why this is the solver behind
    :class:`pymgrid_tpu.algos.mpc_jax.BatchedMPC`.

    ``newton_refine``: rounds of iterative refinement on each Newton solve
    (residual matvec + one extra pair of triangular solves, reusing the
    Cholesky factor).  The normal equations' conditioning is what caps
    float32 accuracy, so refinement buys ~1-2 digits in float32 at a few
    percent per-iteration cost.  Defaults to 1 for float32, 0 for
    float64.

    ``matmul_precision``: precision of every matmul traced here (a
    ``jax.default_matmul_precision`` name).  ``"float32"`` (default) is the
    accuracy anchor: reduced-precision products (bfloat16, or the TF32 that
    NVIDIA GPUs use for float32 by default) wreck the normal equations.
    ``"tensorfloat32"`` trades the last digits for speed; pair it with
    ``newton_refine>=2``.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    if newton_refine is None:
        newton_refine = 0 if np.dtype(dtype) == np.float64 else 1

    K_eq = np.asarray(K_eq, dtype=np.float64)
    K_in = np.asarray(K_in, dtype=np.float64)

    # Heterogeneous mode: 3-D ``K_eq (S, me, n0)`` / ``K_in (S, mi, n0)``
    # stack S structurally-identical problems with different matrix VALUES
    # (e.g. the 25 pymgrid scenarios' SOC recursions).  ``solve`` then takes
    # batches of B = k*S problems laid out in (k, S) blocks — problem
    # ``i*S + s`` uses matrix ``s`` — and every iteration runs one batched
    # matmul/Cholesky over all of them.
    if K_eq.ndim == 2:
        K_eq = K_eq[None]
        K_in = K_in[None]
        if x_scale is not None:
            x_scale = np.asarray(x_scale, dtype=np.float64)[None]
    S, me, n0 = K_eq.shape
    mi = K_in.shape[1]
    m = me + mi
    n = n0 + mi  # with slacks

    # Variable scaling: problems mixing O(1e4) power flows with O(1) SOC
    # variables wreck the normal-equation conditioning.  ``x_scale``
    # (S, n0) gives each structural variable's magnitude; slacks inherit
    # their row's implied magnitude ``|K_in| @ x_scale``.
    if x_scale is None:
        col_scale = np.ones((S, n))
    else:
        x_scale = np.maximum(np.asarray(x_scale, dtype=np.float64), 1e-8)
        assert x_scale.shape == (S, n0)
        s_scale = np.maximum(
            np.einsum("smn,sn->sm", np.abs(K_in), x_scale), 1e-8
        )
        col_scale = np.concatenate([x_scale, s_scale], axis=1)

    A_np = np.zeros((S, m, n))
    A_np[:, :me, :n0] = K_eq
    A_np[:, me:, :n0] = K_in
    A_np[:, me:, n0:] = np.eye(mi)[None]
    A_np = A_np * col_scale[:, None, :]

    # equilibrate rows for numerical stability
    row_scale = 1.0 / np.maximum(np.abs(A_np).max(axis=2), 1e-8)
    A_np = A_np * row_scale[:, :, None]

    A = jnp.asarray(A_np, dtype)                      # (S, m, n)
    row_scale_j = jnp.asarray(row_scale, dtype)       # (S, m)
    col_scale_j = jnp.asarray(col_scale, dtype)       # (S, n)

    def mm_AT(v):
        """(k, S, n) @ A'_s -> (k, S, m)"""
        return jnp.einsum("ksn,smn->ksm", v, A)

    def mm_A(y):
        """(k, S, m) @ A_s -> (k, S, n)"""
        return jnp.einsum("ksm,smn->ksn", y, A)

    def solve(c, b, h):
        # Accelerators default float32 matmuls to reduced-precision products
        # (TF32 on NVIDIA GPUs), which wreck the normal equations.  Force
        # the requested precision for everything traced here (incl.
        # Cholesky internals).
        with jax.default_matmul_precision(matmul_precision):
            return _solve(c, b, h)

    def _solve(c, b, h):
        B = c.shape[0]
        if B % S:
            raise ValueError(
                f"batch {B} must be a multiple of the matrix stack size {S}"
            )
        k = B // S
        c3 = c.reshape(k, S, n0)
        cc = jnp.concatenate(
            [c3, jnp.zeros((k, S, mi), dtype)], axis=2
        ) * col_scale_j[None, :, :]
        bb = jnp.concatenate(
            [b.reshape(k, S, me), h.reshape(k, S, mi)], axis=2
        ) * row_scale_j[None, :, :]

        # normalize the objective per problem (scalar; argmin-invariant) so
        # the starting point sits at the scale of the solution, not the costs
        c_mag = jnp.maximum(jnp.abs(cc).max(axis=2, keepdims=True), 1.0)
        cc = cc / c_mag

        # standard starting point (strictly positive, scaled to the data)
        scale = 1.0 + jnp.maximum(
            jnp.abs(bb).max(axis=2), jnp.abs(cc).max(axis=2)
        )[:, :, None]
        x = jnp.ones((k, S, n), dtype) * scale
        z = jnp.ones((k, S, n), dtype) * scale
        y = jnp.zeros((k, S, m), dtype)

        eye = jnp.eye(m, dtype=dtype)

        def merit(x, y, z):
            """Progress metric: complementarity + primal/dual infeasibility."""
            r_b = mm_AT(x) - bb
            r_c = mm_A(y) + z - cc
            mu = (x * z).sum(axis=2, keepdims=True) / n
            return (
                mu
                + jnp.abs(r_b).max(axis=2, keepdims=True)
                + jnp.abs(r_c).max(axis=2, keepdims=True)
            )

        def body(carry, _):
            x, y, z, best = carry
            r_b = mm_AT(x) - bb                 # primal residual
            r_c = mm_A(y) + z - cc              # dual residual
            mu = (x * z).sum(axis=2, keepdims=True) / n

            d = jnp.clip(x / z, 1e-10, 1e10)
            # M = A diag(d) A' per problem, via one batched matmul
            Ad = d[:, :, None, :] * A[None, :, :, :]       # (k, S, m, n)
            M = jnp.einsum("ksmn,sln->ksml", Ad, A)
            M = M + 1e-11 * scale[:, :, :, None] * eye[None, None, :, :]
            L = jnp.linalg.cholesky(M)

            if solve_mode == "inverse":
                # Explicit M^-1 once per iteration: Mehrotra + iterative
                # refinement issues ~12 triangular solves per iteration;
                # ONE multi-RHS triangular pair (vs identity) turns every
                # Newton solve into a matvec.  The inverse's extra
                # rounding is recovered by the refinement matvecs.
                w = jax.scipy.linalg.solve_triangular(
                    L, jnp.broadcast_to(eye, M.shape), lower=True
                )
                Minv = jax.scipy.linalg.solve_triangular(
                    jnp.swapaxes(L, -1, -2), w, lower=False
                )

                def chol_solve(rhs):
                    return jnp.einsum("ksml,ksl->ksm", Minv, rhs)
            else:
                def chol_solve(rhs):
                    w = jax.scipy.linalg.solve_triangular(
                        L, rhs[..., None], lower=True
                    )
                    return jax.scipy.linalg.solve_triangular(
                        jnp.swapaxes(L, -1, -2), w, lower=False
                    )[..., 0]

            def solve_newton(r_xz):
                rhs = -r_b + mm_AT((r_xz - x * r_c) / z)
                dy = chol_solve(rhs)
                for _ in range(newton_refine):
                    resid = rhs - jnp.einsum("ksml,ksl->ksm", M, dy)
                    dy = dy + chol_solve(resid)
                dz = -r_c - mm_A(dy)
                dx = -(r_xz + x * dz) / z
                return dx, dy, dz

            def max_step(v, dv):
                ratio = jnp.where(dv < 0, -v / dv, jnp.inf)
                return jnp.minimum(1.0, 0.995 * ratio.min(axis=2, keepdims=True))

            # predictor
            dx_a, dy_a, dz_a = solve_newton(x * z)
            a_p = max_step(x, dx_a)
            a_d = max_step(z, dz_a)
            mu_aff = (
                ((x + a_p * dx_a) * (z + a_d * dz_a)).sum(axis=2, keepdims=True) / n
            )
            sigma = (mu_aff / mu) ** 3

            # corrector (reuses the factorization)
            r_xz = x * z + dx_a * dz_a - sigma * mu
            dx, dy, dz = solve_newton(r_xz)
            a_p = max_step(x, dx)
            a_d = max_step(z, dz)

            # Near the solution the normal equations grow ill-conditioned and
            # Newton steps can blow up.  Keep iterating (unless non-finite)
            # but track the best iterate by merit and return that — a
            # diverging tail then cannot spoil a converged solution.
            x_c = x + a_p * dx
            y_c = y + a_d * dy
            z_c = z + a_d * dz
            finite = (
                jnp.isfinite(x_c).all(axis=2, keepdims=True)
                & jnp.isfinite(y_c).all(axis=2, keepdims=True)
                & jnp.isfinite(z_c).all(axis=2, keepdims=True)
            )
            x = jnp.where(finite, x_c, x)
            y = jnp.where(finite, y_c, y)
            z = jnp.where(finite, z_c, z)

            best_x, best_y, best_z, best_merit = best
            m_new = merit(x, y, z)
            improved = m_new < best_merit
            best = (
                jnp.where(improved, x, best_x),
                jnp.where(improved, y, best_y),
                jnp.where(improved, z, best_z),
                jnp.where(improved, m_new, best_merit),
            )
            return (x, y, z, best), None

        best0 = (x, y, z, jnp.full((k, S, 1), jnp.inf, dtype))
        (_, _, _, best), _ = lax.scan(body, (x, y, z, best0), None, length=iters)
        x, y, z, _ = best

        r = jnp.abs(mm_AT(x) - bb).max(axis=2).reshape(B)
        x_out = (x[:, :, :n0] * col_scale_j[None, :, :n0]).reshape(B, n0)
        obj = (c * x_out).sum(axis=1)
        gap = (x * z).sum(axis=2).reshape(B) / n
        return x_out, {"residual": r, "objective": obj, "gap": gap}

    return jax.jit(solve)


def make_batched_lp_solver(K_eq, K_in, iters=8000, restart_every=200,
                           dtype=np.float32):
    """Build a jitted batched solver ``solve(c, b, h) -> (x, info)``.

    ``K_eq (me, n)`` and ``K_in (mi, n)`` are static; ``c (B, n)``,
    ``b (B, me)``, ``h (B, mi)`` are batched.  PDHG with Ruiz scaling,
    per-problem primal weighting (tau/sigma balanced by ||q||/||c||) and
    ergodic-average restarts every ``restart_every`` iterations — the
    restart scheme that gives PDLP its fast tail convergence.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    K_eq = np.asarray(K_eq, dtype=np.float64)
    K_in = np.asarray(K_in, dtype=np.float64)
    me, n = K_eq.shape
    mi = K_in.shape[0]

    K = np.concatenate([K_eq, K_in], axis=0)
    K_scaled, d_r, d_c = ruiz_scale(K)

    # spectral norm of the scaled matrix via power iteration (host, once)
    v = np.random.RandomState(0).randn(n)
    for _ in range(50):
        v = K_scaled.T @ (K_scaled @ v)
        v /= np.linalg.norm(v)
    sigma_max = float(np.sqrt(np.linalg.norm(K_scaled.T @ (K_scaled @ v))))

    eta = 0.9 / sigma_max  # tau*sigma*||K||^2 < 1 with tau=eta*w, sigma=eta/w

    Kj = jnp.asarray(K_scaled, dtype)
    KjT = jnp.asarray(K_scaled.T, dtype)
    d_r_j = jnp.asarray(d_r, dtype)
    d_c_j = jnp.asarray(d_c, dtype)

    n_restarts = max(iters // restart_every, 1)

    def solve(c, b, h):
        with jax.default_matmul_precision("float32"):  # see IPM note above
            return _solve(c, b, h)

    def _solve(c, b, h):
        B = c.shape[0]
        # scale the problem: x = D_c x', rows scaled by D_r
        c_s = c * d_c_j[None, :]
        q = jnp.concatenate([b, h], axis=1) * d_r_j[None, :]

        # primal weight per problem (PDLP init: ||q|| / ||c||)
        w = jnp.sqrt(
            (jnp.linalg.norm(q, axis=1) + 1e-12)
            / (jnp.linalg.norm(c_s, axis=1) + 1e-12)
        )[:, None]
        tau = eta * w
        sigma = eta / w

        x = jnp.zeros((B, n), dtype)
        y = jnp.zeros((B, me + mi), dtype)

        def inner(carry, _):
            x, y, x_sum, y_sum, k = carry
            x_new = jnp.maximum(x - tau * (c_s + y @ Kj), 0.0)
            x_bar = 2.0 * x_new - x
            y_new = y + sigma * (x_bar @ KjT - q)
            y_new = jnp.concatenate(
                [y_new[:, :me], jnp.maximum(y_new[:, me:], 0.0)], axis=1
            )
            return (x_new, y_new, x_sum + x_new, y_sum + y_new, k + 1), None

        def outer(carry, _):
            x, y = carry
            zero_x = jnp.zeros_like(x)
            zero_y = jnp.zeros_like(y)
            (x, y, x_sum, y_sum, _), _ = lax.scan(
                inner, (x, y, zero_x, zero_y, 0), None, length=restart_every
            )
            # restart from the ergodic average of the epoch
            return (x_sum / restart_every, y_sum / restart_every), None

        (x, y), _ = lax.scan(outer, (x, y), None, length=n_restarts)

        def residual(xx):
            r = xx @ KjT - q
            r_eq = jnp.abs(r[:, :me]).max(axis=1)
            r_in = jnp.maximum(r[:, me:], 0.0).max(axis=1)
            return jnp.maximum(r_eq, r_in)

        res = residual(x)
        x_out = x * d_c_j[None, :]
        obj = (c * x_out).sum(axis=1)
        return x_out, {"residual": res, "objective": obj}

    return jax.jit(solve)


def make_batched_box_ipm_solver(K_eq, K_in, iters=35, dtype=np.float64,
                                x_scale=None, newton_refine=None,
                                matmul_precision="float32"):
    """Batched Mehrotra IPM exploiting the MPC LP's BOX structure.

    Every inequality row of the pymgrid horizon problem touches exactly ONE
    variable (caps, SOC bounds, genset semi-continuity — verified for all
    scenario families), so the LP is really

        min c'x   s.t.   K_eq x = b,   lo(h) <= x <= hi(h)

    and the interior-point normal equations shrink from the slack form's
    ``(me+mi) x (me+mi)`` (288x288 at H=24) to ``me x me`` (48x48): the
    batched Cholesky and triangular solves, the IPM's per-iteration floor,
    shrink with the matrix size, which is what makes the all-25
    one-program MPC year tractable.

    Drop-in replacement for :func:`make_batched_ipm_solver`: same
    ``solve(c, b, h)`` signature — the static single-variable row structure
    of ``K_in`` converts each problem's ``h`` into per-variable bounds via
    segment reductions.  Supports the heterogeneous (S, ...) matrix stacks.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    if newton_refine is None:
        newton_refine = 0 if np.dtype(dtype) == np.float64 else 1

    K_eq = np.asarray(K_eq, dtype=np.float64)
    K_in = np.asarray(K_in, dtype=np.float64)
    if K_eq.ndim == 2:
        K_eq = K_eq[None]
        K_in = K_in[None]
        if x_scale is not None:
            x_scale = np.asarray(x_scale, dtype=np.float64)[None]
    S, me, n0 = K_eq.shape
    mi = K_in.shape[1]

    # ---- static row -> (variable, sign, coefficient) maps per stack entry
    nz_counts = (np.abs(K_in) > 0).sum(axis=2)
    if not np.all(nz_counts == 1):
        raise ValueError(
            "box IPM requires every inequality row to touch exactly one "
            "variable; use make_batched_ipm_solver for general rows"
        )
    var_of_row = np.abs(K_in).argmax(axis=2)               # (S, mi)
    coef_of_row = np.take_along_axis(
        K_in, var_of_row[:, :, None], axis=2
    )[:, :, 0]                                             # (S, mi) +-coef
    if not np.all(np.isin(var_of_row, np.arange(n0))):
        raise ValueError("bad row map")

    # column/row equilibration as in the slack solver
    if x_scale is None:
        col_scale = np.ones((S, n0))
    else:
        col_scale = np.maximum(np.asarray(x_scale, dtype=np.float64), 1e-8)
        assert col_scale.shape == (S, n0)
    A_np = K_eq * col_scale[:, None, :]
    row_scale = 1.0 / np.maximum(np.abs(A_np).max(axis=2), 1e-8)
    A_np = A_np * row_scale[:, :, None]

    A = jnp.asarray(A_np, dtype)                           # (S, me, n0)
    row_scale_j = jnp.asarray(row_scale, dtype)
    col_scale_j = jnp.asarray(col_scale, dtype)
    var_of_row_j = jnp.asarray(var_of_row)                 # (S, mi) int
    # row bound value in SCALED variable units: row is coef*x <= h_i, i.e.
    # x <= h_i/coef (coef>0) or x >= h_i/coef (coef<0); x = col_scale * x'
    coef_scaled = coef_of_row * np.take_along_axis(col_scale, var_of_row, axis=1)
    coef_scaled_j = jnp.asarray(coef_scaled, dtype)        # (S, mi)
    plus_mask = jnp.asarray(coef_of_row > 0)
    BIG = jnp.asarray(1e12, dtype)

    n = n0

    def bounds_from_h(h):
        """h (k, S, mi) -> (lo, hi) (k, S, n0) in scaled variable units."""
        bound = h / coef_scaled_j[None, :, :]

        def per_problem(bound_s, s):
            v = var_of_row_j[s]
            hi_rows = jnp.where(plus_mask[s], bound_s, BIG)
            lo_rows = jnp.where(plus_mask[s], 0.0, bound_s)
            hi = jnp.full((n,), BIG, dtype).at[v].min(hi_rows)
            lo = jnp.zeros((n,), dtype).at[v].max(lo_rows)
            return lo, hi

        los, his = [], []
        for s in range(S):
            lo_s, hi_s = jax.vmap(lambda bs: per_problem(bs, s))(bound[:, s])
            los.append(lo_s)
            his.append(hi_s)
        lo = jnp.stack(los, axis=1)
        hi = jnp.stack(his, axis=1)
        return lo, hi

    def mm_AT(v):
        """(k, S, n) -> (k, S, me):  A_s v"""
        return jnp.einsum("ksn,smn->ksm", v, A)

    def mm_A(y):
        """(k, S, me) -> (k, S, n):  A_s' y"""
        return jnp.einsum("ksm,smn->ksn", y, A)

    def solve(c, b, h):
        with jax.default_matmul_precision(matmul_precision):
            return _solve(c, b, h)

    def _solve(c, b, h):
        B = c.shape[0]
        if B % S:
            raise ValueError(
                f"batch {B} must be a multiple of the matrix stack size {S}"
            )
        k = B // S
        cc = c.reshape(k, S, n0) * col_scale_j[None, :, :]
        bb = b.reshape(k, S, me) * row_scale_j[None, :, :]
        lo, hi = bounds_from_h(h.reshape(k, S, mi))
        # DEGENERATE boxes (genset-off production, outage grid flows) are
        # PINNED: the variable sits inert at lo and is masked out of the
        # barrier.  The previous width-floor + clamped interior start
        # (s0 >= 1e-2, t >= 1e-2) initialized s + t != width, handing the
        # variable a phantom ~2e-2-wide box the s/t update invariant then
        # preserved — e.g. ~640 units of free "genset" energy at
        # col_scale 6.4e4, which made infeasible off-patterns win the MILP
        # enumeration with undershot objectives.
        pin_tol = jnp.asarray(1e-5, dtype)
        pinned = (hi - lo) <= pin_tol * (1.0 + jnp.abs(hi))
        free = 1.0 - pinned.astype(dtype)
        width = jnp.maximum(hi - lo, 1e-6 * (1.0 + jnp.abs(hi)))
        hi_w = lo + width

        c_mag = jnp.maximum(jnp.abs(cc).max(axis=2, keepdims=True), 1.0)
        cn = cc / c_mag

        # strictly interior start (pinned variables get benign constants —
        # every update below forces their deltas to zero)
        s0 = jnp.maximum(0.5 * width, 1e-2)
        x = lo + s0
        s = jnp.where(pinned, 1.0, s0)
        t = jnp.where(pinned, 1.0, jnp.maximum(hi_w - x, 1e-2))
        scale = 1.0 + jnp.maximum(
            jnp.abs(bb).max(axis=2), jnp.abs(cn).max(axis=2)
        )[:, :, None]
        z = jnp.ones_like(x) * scale
        w = jnp.ones_like(x) * scale
        y = jnp.zeros((k, S, me), dtype)

        eye = jnp.eye(me, dtype=dtype)
        two_n = jnp.maximum(2.0 * free.sum(axis=2, keepdims=True), 1.0)

        def x_of(sv):
            return lo + jnp.where(pinned, 0.0, sv)

        def merit(sv, tv, zv, wv, yv):
            xv = x_of(sv)
            r_b = mm_AT(xv) - bb
            r_c = free * (mm_A(yv) + zv - wv - cn)
            mu = ((free * sv * zv).sum(axis=2, keepdims=True)
                  + (free * tv * wv).sum(axis=2, keepdims=True)) / two_n
            return (
                mu
                + jnp.abs(r_b).max(axis=2, keepdims=True)
                + jnp.abs(r_c).max(axis=2, keepdims=True)
            )

        def body(carry, _):
            s, t, z, w, y, best = carry
            x = x_of(s)
            r_b = mm_AT(x) - bb
            r_c = mm_A(y) + z - w - cn
            mu = ((free * s * z).sum(axis=2, keepdims=True)
                  + (free * t * w).sum(axis=2, keepdims=True)) / two_n

            d = free / jnp.clip(z / s + w / t, 1e-10, 1e10)
            Ad = d[:, :, None, :] * A[None, :, :, :]
            M = jnp.einsum("ksmn,sln->ksml", Ad, A)
            M = M + 1e-11 * scale[:, :, :, None] * eye[None, None, :, :]
            L = jnp.linalg.cholesky(M)

            def chol_solve(rhs):
                wk = jax.scipy.linalg.solve_triangular(
                    L, rhs[..., None], lower=True
                )
                return jax.scipy.linalg.solve_triangular(
                    jnp.swapaxes(L, -1, -2), wk, lower=False
                )[..., 0]

            def newton(rs, rt):
                """Solve for (dx, dy, dz, dw) with complementarity targets
                rs = target - s z (row), rt = target - t w."""
                g = r_c + rs / s - rt / t
                rhs = -r_b - mm_AT(d * g)
                dy = chol_solve(rhs)
                for _ in range(newton_refine):
                    resid = rhs - jnp.einsum("ksml,ksl->ksm", M, dy)
                    dy = dy + chol_solve(resid)
                dx = d * (mm_A(dy) + g)
                dz = free * (rs - z * dx) / s
                dw = free * (rt + w * dx) / t
                return dx, dy, dz, dw

            def steps(dx, dz, dw):
                ratio_p = jnp.minimum(
                    jnp.where(dx < 0, -s / dx, jnp.inf),
                    jnp.where(dx > 0, t / dx, jnp.inf),
                )
                a_p = jnp.minimum(1.0, 0.995 * ratio_p.min(axis=2, keepdims=True))
                ratio_d = jnp.minimum(
                    jnp.where(dz < 0, -z / dz, jnp.inf),
                    jnp.where(dw < 0, -w / dw, jnp.inf),
                )
                a_d = jnp.minimum(1.0, 0.995 * ratio_d.min(axis=2, keepdims=True))
                return a_p, a_d

            # predictor (affine)
            dx_a, dy_a, dz_a, dw_a = newton(-s * z, -t * w)
            a_p, a_d = steps(dx_a, dz_a, dw_a)
            mu_aff = (
                (free * (s + a_p * dx_a) * (z + a_d * dz_a)).sum(
                    axis=2, keepdims=True)
                + (free * (t - a_p * dx_a) * (w + a_d * dw_a)).sum(
                    axis=2, keepdims=True)
            ) / two_n
            sigma = (mu_aff / mu) ** 3

            # corrector
            rs = sigma * mu - s * z - dx_a * dz_a
            rt = sigma * mu - t * w + dx_a * dw_a
            dx, dy, dz, dw = newton(rs, rt)
            a_p, a_d = steps(dx, dz, dw)

            s_c = s + a_p * dx
            t_c = t - a_p * dx
            z_c = z + a_d * dz
            w_c = w + a_d * dw
            y_c = y + a_d * dy
            finite = (
                jnp.isfinite(s_c).all(axis=2, keepdims=True)
                & jnp.isfinite(t_c).all(axis=2, keepdims=True)
                & jnp.isfinite(z_c).all(axis=2, keepdims=True)
                & jnp.isfinite(w_c).all(axis=2, keepdims=True)
                & jnp.isfinite(y_c).all(axis=2, keepdims=True)
            )
            s = jnp.where(finite, s_c, s)
            t = jnp.where(finite, t_c, t)
            z = jnp.where(finite, z_c, z)
            w = jnp.where(finite, w_c, w)
            y = jnp.where(finite, y_c, y)

            best_s, best_t, best_z, best_w, best_y, best_merit = best
            m_new = merit(s, t, z, w, y)
            improved = m_new < best_merit
            best = (
                jnp.where(improved, s, best_s),
                jnp.where(improved, t, best_t),
                jnp.where(improved, z, best_z),
                jnp.where(improved, w, best_w),
                jnp.where(improved, y, best_y),
                jnp.where(improved, m_new, best_merit),
            )
            return (s, t, z, w, y, best), None

        best0 = (s, t, z, w, y, jnp.full((k, S, 1), jnp.inf, dtype))
        (_, _, _, _, _, best), _ = lax.scan(
            body, (s, t, z, w, y, best0), None, length=iters
        )
        s, t, z, w, y, _ = best

        # NOTE: a post-IPM feasibility-polish (project onto A x = b with a
        # D-weighted least-squares step) was tried here and REVERTED: it
        # fixed one genset scenario's slice (+3.4% -> +0.8%) but diverged
        # to NaN on most full-year problems (near-degenerate D makes the
        # projection unstable).  Residual-driven improvements belong in the
        # iteration loop, not a one-shot tail step.
        x = jnp.clip(x_of(s), lo, hi)  # exact (incl. degenerate) bounds
        r = jnp.abs(mm_AT(x) - bb).max(axis=2).reshape(B)
        x_out = (x * col_scale_j[None, :, :]).reshape(B, n0)
        obj = (c * x_out).sum(axis=1)
        gap = (
            ((free * s * z).sum(axis=2, keepdims=True)
             + (free * t * w).sum(axis=2, keepdims=True)) / two_n
        ).reshape(B)
        return x_out, {"residual": r, "objective": obj, "gap": gap}

    return jax.jit(solve)
