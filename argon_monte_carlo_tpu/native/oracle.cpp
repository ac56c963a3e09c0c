// Native double-precision physics oracle for differential testing.
//
// The reference has no native components (SURVEY.md section 2: 100%
// Python), so this framework's native layer serves a different
// purpose: an INDEPENDENT scalar implementation of every
// physics kernel, written directly from the physical equations, that the
// fused/vectorized JAX device kernels are tested against on random
// inputs (tests/test_native_oracle.py).  Catching an f32-fusion or
// masking bug requires an implementation that shares no code or
// formulation with the device path -- this is it.
//
// Build: a single translation unit, no dependencies ->
//   g++ -O2 -shared -fPIC oracle.cpp -o liboracle-<hash>.so
// (driven by native/build.py at first use, loaded via ctypes).

#include <cmath>
#include <cstdint>

extern "C" {

// Hard-sphere pair collision: given two particle states overlapping
// within `collision_range`, rewind to contact (larger root of the
// penetration-time quadratic), exchange the elastic impulse along the
// contact normal, replay.  Writes updated pos/vel in place and returns
// the penetration time t (or -1 on degenerate geometry).
// Physics: conservation of momentum and energy for equal masses with the
// impulse along the line of centres.
double oracle_pair_collision(double* p1, double* v1, double* p2,
                             double* v2, double collision_range) {
    double dv[3], dp[3];
    for (int k = 0; k < 3; ++k) {
        dv[k] = v1[k] - v2[k];
        dp[k] = p2[k] - p1[k];
    }
    double a = dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2];
    double b = 2.0 * (dp[0] * dv[0] + dp[1] * dv[1] + dp[2] * dv[2]);
    double c = dp[0] * dp[0] + dp[1] * dp[1] + dp[2] * dp[2]
             - collision_range * collision_range;
    double disc = b * b - 4.0 * a * c;
    if (a <= 0.0 || disc < 0.0) return -1.0;
    double sq = std::sqrt(disc);
    double t = std::fmax((-b + sq) / (2.0 * a), (-b - sq) / (2.0 * a));

    // Rewind to contact.
    double q1[3], q2[3], n[3];
    for (int k = 0; k < 3; ++k) {
        q1[k] = p1[k] - v1[k] * t;
        q2[k] = p2[k] - v2[k] * t;
        n[k] = (q2[k] - q1[k]) / collision_range;
    }
    double rel = dv[0] * n[0] + dv[1] * n[1] + dv[2] * n[2];
    for (int k = 0; k < 3; ++k) {
        v1[k] -= rel * n[k];
        v2[k] += rel * n[k];
        p1[k] = q1[k] + v1[k] * t;
        p2[k] = q2[k] + v2[k] * t;
    }
    return t;
}

// Specular reflection off the plane x[axis] = plane.
// Returns the back-trace time.
double oracle_specular_plane(double* pos, double* vel, int axis,
                             double plane) {
    double v = vel[axis];
    if (v == 0.0) return -1.0;
    double t = (pos[axis] - plane) / v;
    vel[axis] = -v;
    pos[axis] = plane + t * vel[axis];
    return t;
}

// Specular reflection off a cylinder side wall |xy| = radius (axis = z).
// Returns the back-trace time, or -1 when the backward ray misses the
// circle (degenerate; particle untouched).
double oracle_specular_cylinder(double* pos, double* vel, double radius) {
    double x = pos[0], y = pos[1], vx = vel[0], vy = vel[1];
    double a = vx * vx + vy * vy;
    double b = -2.0 * (x * vx + y * vy);
    double c = x * x + y * y - radius * radius;
    double disc = b * b - 4.0 * a * c;
    if (a <= 0.0 || disc < 0.0) return -1.0;
    double sq = std::sqrt(disc);
    double t = std::fmin((-b + sq) / (2.0 * a), (-b - sq) / (2.0 * a));
    double cx = x - vx * t, cy = y - vy * t;
    double nx = cx / radius, ny = cy / radius;
    double dot = vx * nx + vy * ny;
    vel[0] = vx - 2.0 * dot * nx;
    vel[1] = vy - 2.0 * dot * ny;
    pos[0] = cx + vel[0] * t;
    pos[1] = cy + vel[1] * t;
    return t;
}

// Debye-model thermal accommodation: new speed for a particle of kinetic
// energy E hitting a surface of Debye energy E_s with coefficient alpha.
double oracle_thermal_speed(double speed, double surface_energy,
                            double alpha, double mass) {
    double e = 0.5 * mass * speed * speed;
    double e_new = e + (surface_energy - e) * alpha;
    return e_new > 0.0 ? std::sqrt(2.0 * e_new / mass) : 0.0;
}

// Debye integral  int_0^upper x^3/(e^x - 1) dx  by adaptive Simpson --
// deliberately a different quadrature family from the Gauss-Legendre
// used in utils/debye.py.
static double debye_integrand(double x) {
    if (x < 1e-12) return x * x;  // series limit x^3/(e^x-1) -> x^2
    return x * x * x / std::expm1(x);
}

static double simpson(double a, double b) {
    double m = 0.5 * (a + b);
    return (b - a) / 6.0
         * (debye_integrand(a) + 4.0 * debye_integrand(m)
            + debye_integrand(b));
}

static double adaptive(double a, double b, double whole, double eps,
                       int depth) {
    double m = 0.5 * (a + b);
    double left = simpson(a, m), right = simpson(m, b);
    if (depth <= 0 || std::fabs(left + right - whole) < 15.0 * eps)
        return left + right + (left + right - whole) / 15.0;
    return adaptive(a, m, left, eps * 0.5, depth - 1)
         + adaptive(m, b, right, eps * 0.5, depth - 1);
}

double oracle_debye_integral(double upper) {
    return adaptive(0.0, upper, simpson(0.0, upper), 1e-13, 40);
}

// Debye surface energy (Temperature_Pore_MC.py:83-84 formula).
double oracle_surface_energy(double temperature, double t_debye,
                             int num_atoms, double boltzmann) {
    double q = oracle_debye_integral(t_debye / temperature);
    double r = temperature / t_debye;
    return 9.0 * temperature * num_atoms * boltzmann * r * r * r * q;
}

// Vectorized convenience: resolve n_pairs independent pairs
// (arrays of length n_pairs*3 per field).
void oracle_pair_collisions(double* p1, double* v1, double* p2, double* v2,
                            double* t_out, int64_t n_pairs,
                            double collision_range) {
    for (int64_t i = 0; i < n_pairs; ++i) {
        t_out[i] = oracle_pair_collision(p1 + 3 * i, v1 + 3 * i,
                                         p2 + 3 * i, v2 + 3 * i,
                                         collision_range);
    }
}

// Vectorized forms of the wall oracles over n rows (arrays of n*3 per
// field for pos/vel, n for t_out/speed/out).
void oracle_specular_planes(double* pos, double* vel, double* t_out,
                            int64_t n, int axis, double plane) {
    for (int64_t i = 0; i < n; ++i) {
        t_out[i] = oracle_specular_plane(pos + 3 * i, vel + 3 * i, axis,
                                         plane);
    }
}

void oracle_specular_cylinders(double* pos, double* vel, double* t_out,
                               int64_t n, double radius) {
    for (int64_t i = 0; i < n; ++i) {
        t_out[i] = oracle_specular_cylinder(pos + 3 * i, vel + 3 * i,
                                            radius);
    }
}

void oracle_thermal_speeds(const double* speed, double* out, int64_t n,
                           double surface_energy, double alpha,
                           double mass) {
    for (int64_t i = 0; i < n; ++i) {
        out[i] = oracle_thermal_speed(speed[i], surface_energy, alpha,
                                      mass);
    }
}

}  // extern "C"
