"""Production cloud-init generation for direct kubelet join (VPC mode).

Capability parity with the reference's bootstrap template
(``pkg/providers/vpc/bootstrap/cloudinit.go:29-1030``): containerd
installation + config, per-plugin/per-version CNI install branches,
kubelet systemd unit with TLS bootstrap, architecture-conditional binary
downloads, kubelet-config subset from the NodeClass, environment-variable
injection (``InjectBootstrapEnvVars``, cloudinit.go:994-1028), and the
userData override/append contract — designed fresh for this framework
(single builder assembling write_files + runcmd sections) rather than a
translation of the reference's Go template.

Layout of the generated document:

- ``#cloud-config`` header with hostname + package prep
- ``write_files``: sysctl/module config, containerd config.toml, kubelet
  KubeletConfiguration YAML, bootstrap kubeconfig (TLS bootstrap token),
  kubelet systemd service + drop-in, install helper script
- ``runcmd``: run the install helper (binaries per arch), install CNI per
  plugin branch, enable services, join verification marker

(Copy of ``karpenter_tpu/core/cloudinit.py``.)
"""

from __future__ import annotations

from dataclasses import dataclass, field

# Download endpoints are parameterized so air-gapped mirrors can override
# them through BootstrapEnv (the env-injection contract).
DEFAULT_K8S_DOWNLOAD = "https://dl.k8s.io/release"
DEFAULT_CONTAINERD_DOWNLOAD = "https://github.com/containerd/containerd/releases/download"
DEFAULT_RUNC_DOWNLOAD = "https://github.com/opencontainers/runc/releases/download"
DEFAULT_CNI_PLUGINS_DOWNLOAD = "https://github.com/containernetworking/plugins/releases/download"

CONTAINERD_VERSION = "1.7.27"
RUNC_VERSION = "1.2.6"
CNI_PLUGINS_VERSION = "1.6.2"
PAUSE_IMAGE = "registry.k8s.io/pause:3.10"

# kubelet defaults mirrored from the provider's capacity model
DEFAULT_CLUSTER_DOMAIN = "cluster.local"

SUPPORTED_ARCHES = ("amd64", "arm64")
SUPPORTED_CNI_PLUGINS = ("calico", "cilium", "flannel", "none")


@dataclass
class BootstrapEnv:
    """Environment injected into the generated script (ref
    InjectBootstrapEnvVars, cloudinit.go:994-1028): mirrors/proxies and
    arbitrary KEY=VALUE pairs surfaced to the install helper and the
    kubelet unit."""

    k8s_download: str = DEFAULT_K8S_DOWNLOAD
    containerd_download: str = DEFAULT_CONTAINERD_DOWNLOAD
    runc_download: str = DEFAULT_RUNC_DOWNLOAD
    cni_plugins_download: str = DEFAULT_CNI_PLUGINS_DOWNLOAD
    http_proxy: str = ""
    https_proxy: str = ""
    no_proxy: str = ""
    extra: tuple[tuple[str, str], ...] = ()

    def as_pairs(self) -> list[tuple[str, str]]:
        pairs = [
            ("KARPENTER_K8S_DOWNLOAD", self.k8s_download),
            ("KARPENTER_CONTAINERD_DOWNLOAD", self.containerd_download),
            ("KARPENTER_RUNC_DOWNLOAD", self.runc_download),
            ("KARPENTER_CNI_PLUGINS_DOWNLOAD", self.cni_plugins_download),
        ]
        if self.http_proxy:
            pairs.append(("HTTP_PROXY", self.http_proxy))
        if self.https_proxy:
            pairs.append(("HTTPS_PROXY", self.https_proxy))
        if self.no_proxy:
            pairs.append(("NO_PROXY", self.no_proxy))
        pairs.extend(self.extra)
        return pairs


def _indent(text: str, spaces: int) -> str:
    pad = " " * spaces
    return "\n".join(pad + line if line else line
                     for line in text.splitlines())


def _yaml_quote(s: str) -> str:
    """Quote a runcmd entry as a YAML double-quoted scalar — unquoted
    plain scalars turn any command containing ': ' into a YAML mapping,
    which cloud-init's shellify rejects (node never joins).  JSON string
    quoting is a strict subset of YAML double-quoted style."""
    import json

    return json.dumps(s)


def _sh_single_quote(s: str) -> str:
    """Shell-safe single quoting for env values ($, backticks, quotes
    must not be expanded inside the install script's exports)."""
    return "'" + s.replace("'", "'\\''") + "'"


def _systemd_escape(s: str) -> str:
    """Escape a value for systemd Environment="K=V" (backslashes and
    embedded double quotes)."""
    return s.replace("\\", "\\\\").replace('"', '\\"')


def containerd_config() -> str:
    """containerd config.toml: systemd cgroups (required for kubelet
    cgroupDriver=systemd), pinned sandbox image, CNI dirs (ref template's
    containerd section)."""
    return f"""version = 2
root = "/var/lib/containerd"
state = "/run/containerd"

[plugins."io.containerd.grpc.v1.cri"]
  sandbox_image = "{PAUSE_IMAGE}"
  [plugins."io.containerd.grpc.v1.cri".containerd]
    default_runtime_name = "runc"
    [plugins."io.containerd.grpc.v1.cri".containerd.runtimes.runc]
      runtime_type = "io.containerd.runc.v2"
      [plugins."io.containerd.grpc.v1.cri".containerd.runtimes.runc.options]
        SystemdCgroup = true
  [plugins."io.containerd.grpc.v1.cri".cni]
    bin_dir = "/opt/cni/bin"
    conf_dir = "/etc/cni/net.d"
  [plugins."io.containerd.grpc.v1.cri".registry]
    config_path = "/etc/containerd/certs.d"
"""


def kubelet_configuration(cluster, kubelet=None,
                          max_pods: int = 0) -> str:
    """KubeletConfiguration YAML: TLS bootstrap + cert rotation, systemd
    cgroup driver, clusterDNS/domain, and the NodeClass kubelet subset
    (maxPods, reserved resources, eviction thresholds —
    ibmnodeclass_types.go:318-387 parity)."""
    dns = list(kubelet.cluster_dns) if kubelet and kubelet.cluster_dns \
        else [cluster.cluster_dns]
    lines = [
        "apiVersion: kubelet.config.k8s.io/v1beta1",
        "kind: KubeletConfiguration",
        "authentication:",
        "  anonymous: {enabled: false}",
        "  webhook: {enabled: true}",
        "  x509: {clientCAFile: /etc/kubernetes/pki/ca.crt}",
        "authorization: {mode: Webhook}",
        "cgroupDriver: systemd",
        "containerRuntimeEndpoint: unix:///run/containerd/containerd.sock",
        f"clusterDomain: {DEFAULT_CLUSTER_DOMAIN}",
        "clusterDNS:",
    ]
    lines += [f"  - {ip}" for ip in dns]
    lines += [
        "rotateCertificates: true",
        "serverTLSBootstrap: true",
        "featureGates: {RotateKubeletServerCertificate: true}",
    ]
    effective_max = (kubelet.max_pods if kubelet and kubelet.max_pods
                     else max_pods)
    if effective_max:
        lines.append(f"maxPods: {effective_max}")
    if kubelet and kubelet.system_reserved:
        lines.append("systemReserved:")
        lines += [f"  {k}: {v!r}" for k, v in kubelet.system_reserved]
    if kubelet and kubelet.kube_reserved:
        lines.append("kubeReserved:")
        lines += [f"  {k}: {v!r}" for k, v in kubelet.kube_reserved]
    if kubelet and kubelet.eviction_hard:
        lines.append("evictionHard:")
        lines += [f"  {k}: {v!r}" for k, v in kubelet.eviction_hard]
    return "\n".join(lines) + "\n"


def bootstrap_kubeconfig(cluster, token: str) -> str:
    """TLS-bootstrap kubeconfig: the token authenticates the kubelet's
    first CSR; cert rotation takes over after approval (token.go flow)."""
    return f"""apiVersion: v1
kind: Config
clusters:
- cluster:
    certificate-authority-data: {cluster.cluster_ca}
    server: {cluster.api_endpoint}
  name: default
contexts:
- context: {{cluster: default, user: kubelet-bootstrap}}
  name: default
current-context: default
users:
- name: kubelet-bootstrap
  user:
    token: {token}
"""


def kubelet_unit(node_name: str, labels: dict[str, str], taints,
                 extra_args: dict[str, str],
                 env_pairs: list[tuple[str, str]]) -> str:
    """kubelet systemd service with registration args (labels + taints)
    and injected environment."""
    label_args = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    taint_args = ",".join(f"{t.key}={t.value}:{t.effect}" for t in taints)
    extra = " ".join(f"--{k}={v}" for k, v in sorted(extra_args.items()))
    env_lines = "\n".join(f'Environment="{k}={_systemd_escape(v)}"'
                          for k, v in env_pairs)
    return f"""[Unit]
Description=kubelet: The Kubernetes Node Agent
Documentation=https://kubernetes.io/docs/
After=containerd.service network-online.target
Wants=containerd.service network-online.target

[Service]
{env_lines}
ExecStart=/usr/local/bin/kubelet \\
  --config=/var/lib/kubelet/config.yaml \\
  --bootstrap-kubeconfig=/etc/kubernetes/bootstrap-kubeconfig \\
  --kubeconfig=/var/lib/kubelet/kubeconfig \\
  --hostname-override={node_name} \\
  --node-labels={label_args} \\
  --register-with-taints={taint_args} {extra}
Restart=always
RestartSec=10
KillMode=process

[Install]
WantedBy=multi-user.target
"""


def install_script(cluster, architecture: str,
                   env_pairs: list[tuple[str, str]]) -> str:
    """Binary installation helper: containerd + runc + CNI plugin
    binaries + kubelet, all architecture-conditional (the ref template
    branches on arch the same way), idempotent, fail-fast."""
    if architecture not in SUPPORTED_ARCHES:
        raise ValueError(f"unsupported architecture {architecture!r} "
                         f"(supported: {SUPPORTED_ARCHES})")
    if cluster.container_runtime != "containerd":
        # kubelet is pinned to the containerd socket; silently installing
        # containerd for a cri-o cluster would be a lie
        raise ValueError(
            f"unsupported container runtime {cluster.container_runtime!r} "
            "(only 'containerd' is supported)")
    env_exports = "\n".join(f"export {k}={_sh_single_quote(v)}"
                            for k, v in env_pairs)
    return f"""#!/usr/bin/env bash
set -euo pipefail
ARCH="{architecture}"
K8S_VERSION="v{cluster.kubernetes_version}"
{env_exports}

# --- kernel prerequisites -------------------------------------------------
modprobe overlay
modprobe br_netfilter
sysctl --system
swapoff -a
sed -i '/ swap / s/^/#/' /etc/fstab || true

# --- containerd -----------------------------------------------------------
if ! command -v containerd >/dev/null 2>&1; then
  curl -fsSL "${{KARPENTER_CONTAINERD_DOWNLOAD}}/v{CONTAINERD_VERSION}/containerd-{CONTAINERD_VERSION}-linux-${{ARCH}}.tar.gz" \\
    | tar -xz -C /usr/local
  curl -fsSL -o /etc/systemd/system/containerd.service \\
    https://raw.githubusercontent.com/containerd/containerd/main/containerd.service
fi
if ! command -v runc >/dev/null 2>&1; then
  curl -fsSL -o /usr/local/sbin/runc \\
    "${{KARPENTER_RUNC_DOWNLOAD}}/v{RUNC_VERSION}/runc.${{ARCH}}"
  chmod +x /usr/local/sbin/runc
fi
mkdir -p /opt/cni/bin
if [ ! -e /opt/cni/bin/loopback ]; then
  curl -fsSL "${{KARPENTER_CNI_PLUGINS_DOWNLOAD}}/v{CNI_PLUGINS_VERSION}/cni-plugins-linux-${{ARCH}}-v{CNI_PLUGINS_VERSION}.tgz" \\
    | tar -xz -C /opt/cni/bin
fi
systemctl daemon-reload
systemctl enable --now containerd

# --- kubelet --------------------------------------------------------------
if [ ! -x /usr/local/bin/kubelet ]; then
  curl -fsSL -o /usr/local/bin/kubelet \\
    "${{KARPENTER_K8S_DOWNLOAD}}/${{K8S_VERSION}}/bin/linux/${{ARCH}}/kubelet"
  chmod +x /usr/local/bin/kubelet
fi
mkdir -p /var/lib/kubelet /etc/kubernetes/pki /etc/kubernetes/manifests \\
  /var/lib/karpenter
echo "{cluster.cluster_ca}" | base64 -d > /etc/kubernetes/pki/ca.crt
"""


def cni_install_commands(cluster) -> list[str]:
    """Per-plugin CNI installation branch (ref template's CNI section:
    plugin + version selection).  The node-side step differs per plugin:
    calico/flannel need the conf dir primed for the DaemonSet to adopt;
    cilium replaces kube-proxy functions and wants a clean slate."""
    plugin = cluster.cni_plugin
    version = cluster.cni_version
    if plugin == "none":
        # operator-managed CNI: nothing node-side
        return ["echo 'CNI managed externally; skipping node-side install'"]
    if plugin not in SUPPORTED_CNI_PLUGINS:
        raise ValueError(f"unsupported CNI plugin {plugin!r} "
                         f"(supported: {SUPPORTED_CNI_PLUGINS})")
    base = ["mkdir -p /etc/cni/net.d"]
    if plugin == "calico":
        return base + [
            f"echo 'calico/{version}: DaemonSet installs the conflist; "
            "priming dirs' ",
            "mkdir -p /var/lib/calico",
            f"echo '{version}' > /var/lib/calico/expected-version",
        ]
    if plugin == "cilium":
        return base + [
            "rm -f /etc/cni/net.d/*.conflist || true",
            f"echo 'cilium/{version}: agent DaemonSet owns the dataplane'",
            "mount bpffs /sys/fs/bpf -t bpf || true",
        ]
    # flannel
    return base + [
        f"echo 'flannel/{version}: writing static conflist'",
        ("printf '%s' '{\"name\":\"cbr0\",\"cniVersion\":\"0.3.1\","
         "\"plugins\":[{\"type\":\"flannel\",\"delegate\":"
         "{\"hairpinMode\":true,\"isDefaultGateway\":true}},"
         "{\"type\":\"portmap\",\"capabilities\":{\"portMappings\":true}}]}'"
         " > /etc/cni/net.d/10-flannel.conflist"),
        "mkdir -p /run/flannel",
        f"echo 'net: {cluster.cluster_cidr}' > /run/flannel/karpenter-hint",
    ]


def sysctl_config() -> str:
    return """net.bridge.bridge-nf-call-iptables  = 1
net.bridge.bridge-nf-call-ip6tables = 1
net.ipv4.ip_forward                 = 1
"""


def modules_config() -> str:
    return "overlay\nbr_netfilter\n"


def generate_cloud_init(cluster, node_name: str, token: str,
                        architecture: str = "amd64",
                        labels: dict[str, str] | None = None,
                        taints=(), kubelet=None,
                        kubelet_extra_args: dict[str, str] | None = None,
                        env: BootstrapEnv | None = None,
                        max_pods: int = 0) -> str:
    """Assemble the full #cloud-config document."""
    env = env or BootstrapEnv()
    env_pairs = env.as_pairs()
    labels = labels or {}
    files = [
        ("/etc/modules-load.d/k8s.conf", "0644", modules_config()),
        ("/etc/sysctl.d/99-kubernetes.conf", "0644", sysctl_config()),
        ("/etc/containerd/config.toml", "0644", containerd_config()),
        ("/var/lib/kubelet/config.yaml", "0644",
         kubelet_configuration(cluster, kubelet, max_pods)),
        ("/etc/kubernetes/bootstrap-kubeconfig", "0600",
         bootstrap_kubeconfig(cluster, token)),
        ("/etc/systemd/system/kubelet.service", "0644",
         kubelet_unit(node_name, labels, taints,
                      kubelet_extra_args or {}, env_pairs)),
        ("/usr/local/share/karpenter/install-node.sh", "0755",
         install_script(cluster, architecture, env_pairs)),
    ]
    out = [f"#cloud-config",
           f"# karpenter-tpu node bootstrap ({node_name}); "
           f"k8s {cluster.kubernetes_version}, "
           f"{cluster.container_runtime}, "
           f"cni {cluster.cni_plugin}/{cluster.cni_version}, "
           f"arch {architecture}",
           f"hostname: {node_name}",
           "preserve_hostname: false",
           "write_files:"]
    for path, perm, content in files:
        out.append(f"  - path: {path}")
        out.append(f"    permissions: '{perm}'")
        out.append("    content: |")
        out.append(_indent(content.rstrip("\n"), 6))
    out.append("runcmd:")
    cmds = [f"hostnamectl set-hostname {node_name}",
            "bash /usr/local/share/karpenter/install-node.sh"]
    cmds += cni_install_commands(cluster)
    cmds += ["systemctl daemon-reload",
             "systemctl enable --now kubelet",
             # join verification marker: ops can assert bootstrap completed
             # (install-node.sh creates /var/lib/karpenter)
             "touch /var/lib/karpenter/.bootstrapped"]
    # quoted scalars: a plain "echo 'x: y'" would YAML-parse as a mapping
    out.extend(f"  - {_yaml_quote(c)}" for c in cmds)
    return "\n".join(out) + "\n"
