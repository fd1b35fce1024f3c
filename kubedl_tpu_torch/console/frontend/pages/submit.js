// Job submit page (reference pages/JobSubmit + JobCreate): a form that
// renders the manifest (kind, replicas per role, image/command/resources,
// TPU slice policy, data-source volume, code-source git-sync annotation,
// TensorBoard opt-in) with a YAML mode for power users.
import { api, esc, t, tabbed } from "../app.js";

// replica roles the form offers per kind (mirrors each workload's
// reconcile orders; AIMaster intentionally omitted from the form)
const KIND_ROLES = {
  PyTorchJob: ["Master", "Worker"],
  TFJob: ["Chief", "PS", "Worker", "Evaluator"],
  JAXJob: ["Worker"],
  MPIJob: ["Launcher", "Worker"],
  XGBoostJob: ["Master", "Worker"],
  XDLJob: ["Scheduler", "PS", "Worker"],
  MarsJob: ["Scheduler", "WebService", "Worker"],
  ElasticDLJob: ["Master"],
};
const SPEC_FIELD = {
  PyTorchJob: "pytorchReplicaSpecs", TFJob: "tfReplicaSpecs",
  JAXJob: "jaxReplicaSpecs", MPIJob: "mpiReplicaSpecs",
  XGBoostJob: "xgbReplicaSpecs", XDLJob: "xdlReplicaSpecs",
  MarsJob: "marsReplicaSpecs", ElasticDLJob: "elasticdlReplicaSpecs",
};
const MAIN_CONTAINER = {
  PyTorchJob: "pytorch", TFJob: "tensorflow", JAXJob: "jax", MPIJob: "mpi",
  XGBoostJob: "xgboost", XDLJob: "xdl", MarsJob: "mars",
  ElasticDLJob: "elasticdl",
};
const TPU_TYPES = ["", "v4", "v5e", "v5p", "v6e"];

const DEFAULT_YAML = `apiVersion: training.kubedl.io/v1alpha1
kind: JAXJob
metadata:
  name: demo
spec:
  tpuPolicy:
    accelerator: v5p
    topology: 2x2x4
  jaxReplicaSpecs:
    Worker:
      replicas: 4
      template:
        spec:
          containers:
            - name: jax
              image: my-train-image:latest
              resources:
                limits:
                  google.com/tpu: "4"
`;

export async function viewSubmit(app) {
  app.innerHTML = `
    <div class="panel"><h2>${esc(t("submit.title"))}</h2>
      <div id="submit-tabs"></div>
    </div>`;
  tabbed(document.getElementById("submit-tabs"), [
    { id: "form", label: t("submit.form"), render: renderForm },
    { id: "yaml", label: t("submit.yaml"), render: renderYaml },
  ]);
}

function renderYaml(el) {
  el.innerHTML = `
    <p class="muted">Paste a training-job manifest (YAML or JSON).</p>
    <textarea id="manifest">${esc(DEFAULT_YAML)}</textarea>
    <div class="row" style="margin-top:10px">
      <button class="primary" id="go">${esc(t("submit.create"))}</button>
      <span id="msg" class="muted"></span></div>`;
  el.querySelector("#go").onclick = async () => {
    const msg = el.querySelector("#msg");
    try {
      const r = await api("/job/submit", { method: "POST",
        body: el.querySelector("#manifest").value });
      msg.innerHTML = `created <a href="#/job?ns=${esc(r.namespace)}` +
        `&name=${esc(r.name)}">${esc(r.namespace)}/${esc(r.name)}</a>`;
    } catch (e) { msg.textContent = e.message; msg.className = "error"; }
  };
}

async function renderForm(el) {
  // independent lookups in one round-trip; each degrades to its default
  const [ds, cs, ns, im] = await Promise.allSettled([
    api("/datasource"), api("/codesource"),
    api("/kubedl/namespaces"), api("/kubedl/images")]);
  const dataSources = ds.status === "fulfilled" ? ds.value : {};
  const codeSources = cs.status === "fulfilled" ? cs.value : {};
  const namespaces = ns.status === "fulfilled" ? ns.value : ["default"];
  const images = im.status === "fulfilled" ? im.value : {};
  const kinds = Object.keys(KIND_ROLES);
  const imageList = Object.values(images).flat();

  el.innerHTML = `
    <div class="form-grid">
      <label>Kind</label>
      <select id="f-kind">${kinds.map(k => `<option>${k}</option>`).join("")}
      </select>
      <label>Name</label><input id="f-name" placeholder="my-job">
      <label>Namespace</label>
      <input id="f-ns" list="f-namespaces" value="default">
      <datalist id="f-namespaces">${namespaces.map(n =>
        `<option value="${esc(n)}">`).join("")}</datalist>
      <label>Image</label>
      <input id="f-image" list="f-images"
             placeholder="gcr.io/project/train:latest">
      <datalist id="f-images">${imageList.map(i =>
        `<option value="${esc(i)}">`).join("")}</datalist>
      <label>Command</label>
      <input id="f-cmd" placeholder="python train.py --epochs 10">
    </div>
    <fieldset><legend>TPU slice</legend><div class="form-grid">
      <label>Accelerator</label>
      <select id="f-tpu">${TPU_TYPES.map(v =>
        `<option value="${v}">${v || "none (CPU)"}</option>`).join("")}
      </select>
      <label>Topology</label>
      <input id="f-topo" placeholder="2x2x4" disabled>
    </div></fieldset>
    <fieldset><legend>Replicas</legend><div id="f-roles"></div></fieldset>
    <fieldset><legend>Attachments</legend><div class="form-grid">
      <label>Data source</label>
      <select id="f-data"><option value="">none</option>
        ${Object.keys(dataSources).map(n => `<option>${esc(n)}</option>`)
          .join("")}</select>
      <label>Code source</label>
      <select id="f-code"><option value="">none</option>
        ${Object.keys(codeSources).map(n => `<option>${esc(n)}</option>`)
          .join("")}</select>
      <label>TensorBoard</label>
      <span><input type="checkbox" id="f-tb">
        <span class="muted">create a TensorBoard for this job</span></span>
      <label>Log dir</label>
      <input id="f-logdir" placeholder="/workspace/logs" disabled>
    </div></fieldset>
    <div class="row">
      <button class="primary" id="f-go">${esc(t("submit.create"))}</button>
      <button id="f-preview">${esc(t("submit.preview"))}</button>
      <span id="f-msg" class="muted"></span>
    </div>
    <pre id="f-yaml" hidden></pre>`;

  const rolesDiv = el.querySelector("#f-roles");
  const renderRoles = () => {
    const kind = el.querySelector("#f-kind").value;
    rolesDiv.innerHTML = KIND_ROLES[kind].map(role => `
      <div class="replica-card"><h4>${role}</h4><div class="form-grid">
        <label>Replicas</label>
        <input type="number" min="0" value="${role === "Worker" ? 1 : role === "PS" || role === "Evaluator" ? 0 : 1}"
               data-role-count="${role}">
        <label>CPU</label><input data-role-cpu="${role}" placeholder="4">
        <label>Memory</label><input data-role-mem="${role}" placeholder="8Gi">
        <label>TPU chips</label>
        <input data-role-tpu="${role}" placeholder="${role === "Worker" ? "4" : ""}">
      </div></div>`).join("");
  };
  el.querySelector("#f-kind").onchange = renderRoles;
  renderRoles();
  el.querySelector("#f-tpu").onchange = () => {
    el.querySelector("#f-topo").disabled = !el.querySelector("#f-tpu").value;
  };
  el.querySelector("#f-tb").onchange = () => {
    el.querySelector("#f-logdir").disabled = !el.querySelector("#f-tb").checked;
  };

  const buildManifest = () => {
    const kind = el.querySelector("#f-kind").value;
    const name = el.querySelector("#f-name").value.trim();
    const ns = el.querySelector("#f-ns").value.trim() || "default";
    const image = el.querySelector("#f-image").value.trim();
    const cmd = el.querySelector("#f-cmd").value.trim();
    const dataName = el.querySelector("#f-data").value;
    const codeName = el.querySelector("#f-code").value;
    const specs = {};
    for (const role of KIND_ROLES[kind]) {
      const count = parseInt(
        el.querySelector(`[data-role-count="${role}"]`).value || "0");
      if (!count) continue;
      const limits = {};
      const cpu = el.querySelector(`[data-role-cpu="${role}"]`).value.trim();
      const mem = el.querySelector(`[data-role-mem="${role}"]`).value.trim();
      const tpu = el.querySelector(`[data-role-tpu="${role}"]`).value.trim();
      if (cpu) limits.cpu = cpu;
      if (mem) limits.memory = mem;
      if (tpu) limits["google.com/tpu"] = tpu;
      const container = {
        name: MAIN_CONTAINER[kind], image,
        ...(cmd ? { command: ["sh", "-c", cmd] } : {}),
        ...(Object.keys(limits).length ? { resources: { limits } } : {}),
      };
      const podSpec = { containers: [container] };
      if (dataName && dataSources[dataName]) {
        const ds = dataSources[dataName];
        container.volumeMounts = [{
          name: "data", mountPath: ds.local_path || "/data" }];
        podSpec.volumes = [{ name: "data",
          persistentVolumeClaim: { claimName: ds.pvc_name } }];
      }
      specs[role] = { replicas: count, restartPolicy: "Never",
                      template: { spec: podSpec } };
    }
    const manifest = {
      apiVersion: "training.kubedl.io/v1alpha1", kind,
      metadata: { name, namespace: ns, annotations: {} },
      spec: { [SPEC_FIELD[kind]]: specs },
    };
    const tpuType = el.querySelector("#f-tpu").value;
    if (tpuType) {
      manifest.spec.tpuPolicy = { accelerator: tpuType,
        topology: el.querySelector("#f-topo").value.trim() || "2x2x1" };
    }
    if (codeName && codeSources[codeName]) {
      const cs = codeSources[codeName];
      manifest.metadata.annotations["kubedl.io/git-sync-config"] =
        JSON.stringify({ source: cs.code_path,
          branch: cs.default_branch || "main",
          destPath: cs.local_path || "/workspace/code" });
    }
    if (el.querySelector("#f-tb").checked) {
      manifest.metadata.annotations["kubedl.io/tensorboard-config"] =
        JSON.stringify({ logDir:
          el.querySelector("#f-logdir").value.trim() || "/workspace/logs" });
    }
    if (!Object.keys(manifest.metadata.annotations).length)
      delete manifest.metadata.annotations;
    return manifest;
  };

  el.querySelector("#f-preview").onclick = () => {
    const pre = el.querySelector("#f-yaml");
    pre.hidden = false;
    pre.textContent = JSON.stringify(buildManifest(), null, 2);
  };
  el.querySelector("#f-go").onclick = async () => {
    const msg = el.querySelector("#f-msg");
    msg.className = "muted";
    const manifest = buildManifest();
    if (!manifest.metadata.name) {
      msg.textContent = "name is required"; msg.className = "error"; return;
    }
    if (!Object.values(manifest.spec)[0] ||
        !Object.keys(Object.values(manifest.spec)[0]).length) {
      msg.textContent = "at least one replica role"; msg.className = "error";
      return;
    }
    try {
      const r = await api("/job/submit", { method: "POST",
        body: JSON.stringify(manifest) });
      msg.innerHTML = `created <a href="#/job?kind=${esc(manifest.kind)}` +
        `&ns=${esc(r.namespace)}&name=${esc(r.name)}">` +
        `${esc(r.namespace)}/${esc(r.name)}</a>`;
    } catch (e) { msg.textContent = e.message; msg.className = "error"; }
  };
}
